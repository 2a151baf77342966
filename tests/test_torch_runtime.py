"""The port's runtime and data slice: checkpoints, the watchdog, the
synthetic stream and the training launcher, on the CPU.

Mirrors ``tests/test_runtime.py``; the stream equals the reference's
batch for batch, and a checkpoint written by either package restores in
the other with equal leaves (fp32, int32 and bf16).
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.runtime.checkpoint import (                   # noqa: E402
    CheckpointManager as JCheckpointManager)
from repro_torch.core import tree                        # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train     # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.watchdog import (PreemptionHandler,  # noqa: E402
                                          StepWatchdog)


def _eq(t, a):
    """A port leaf and a reference leaf hold the same bits."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        assert a.dtype.itemsize == 2
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        np.testing.assert_array_equal(t.numpy(), a)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 4))},
                 "s": (torch.tensor(3, dtype=torch.int32),
                       torch.randn(5).to(torch.bfloat16))}
        mgr.save(5, state, extra={"data_step": 17})
        restored, extra = mgr.restore(5, state)
        assert extra == {"data_step": 17}
        for x, y in zip(tree.leaves(state), tree.leaves(restored)):
            assert x.dtype == y.dtype and torch.equal(x, y)

    def test_async_save_and_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state = {"w": torch.ones(16)}
        mgr.save_async(1, state)
        state["w"].add_(1.0)             # after the snapshot: not in step 1
        mgr.save_async(2, state)
        mgr.wait()
        assert mgr.latest_step() == 2
        assert torch.equal(mgr.restore(1, state)[0]["w"], torch.ones(16))

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in range(5):
            mgr.save(s, {"w": torch.ones(4)})
        assert mgr.all_steps() == [3, 4]

    def test_atomic_no_tmp_left(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.ones(4)})
        assert not any(d.endswith("_tmp") for d in os.listdir(tmp_path))

    def test_structure_mismatch_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.ones(4)})
        with pytest.raises(ValueError):
            mgr.restore(1, {"w": torch.ones(4), "extra": torch.ones(2)})


def _state(rng):
    """A train-state-shaped tree: bf16 params, fp32 moments, int32 step."""
    w = rng.standard_normal((3, 4)).astype(np.float32)
    return {"params": {"layers": ({"wq": w}, {"wq": 2 * w}),
                       "ln": rng.standard_normal(4).astype(np.float32)},
            "opt": {"step": np.int32(7),
                    "mu": rng.standard_normal((2, 5)).astype(np.float32)}}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, bf16):
    ref = _state(np.random.default_rng(0))
    if bf16:
        ref["params"]["layers"] = tuple(
            {"wq": x["wq"].astype(ml_dtypes.bfloat16)}
            for x in ref["params"]["layers"])
    ours = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a).view(np.int16).copy())
        .view(torch.bfloat16) if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.as_tensor(np.asarray(a)), ref)
    CheckpointManager(str(tmp_path)).save(3, ours, extra={"k": 1})
    like = jax.tree_util.tree_map(jnp.asarray, ref)
    restored, extra = JCheckpointManager(str(tmp_path)).restore(3, like)
    assert extra == {"k": 1}
    for t, a in zip(tree.leaves(ours), jax.tree_util.tree_leaves(restored)):
        _eq(t, a)
    with open(tmp_path / "step_00000003" / "index.json") as f:
        index = json.load(f)
    assert [e["path"] for e in index["leaves"]] == [
        "opt/mu", "opt/step", "params/layers/0/wq", "params/layers/1/wq",
        "params/ln"]
    if bf16:
        path = tmp_path / "step_00000003" / index["leaves"][2]["file"]
        with open(path, "rb") as f:
            np.lib.format.read_magic(f)
            header = np.lib.format.read_array_header_1_0(f)
        assert index["leaves"][2]["dtype"] == "bfloat16"
        assert np.dtype(ml_dtypes.bfloat16).descr == [("", "<V2")]
        assert b"'<V2'" in path.read_bytes()[:128] and header[0] == (3, 4)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, bf16):
    ref = jax.tree_util.tree_map(jnp.asarray,
                                 _state(np.random.default_rng(1)))
    if bf16:
        ref["params"] = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), ref["params"])
    JCheckpointManager(str(tmp_path)).save(4, ref, extra={"data": {"step": 2}})
    like = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), ref)
    restored, extra = CheckpointManager(str(tmp_path)).restore(4, like)
    assert extra == {"data": {"step": 2}}
    for t, a in zip(tree.leaves(restored), jax.tree_util.tree_leaves(ref)):
        assert t.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                           else getattr(torch, a.dtype.name))
        _eq(t, a)


class TestWatchdog:
    def test_straggler_detection(self):
        wd = StepWatchdog(ema_alpha=0.5, threshold=2.0)
        for _ in range(5):
            assert not wd.record_step(1.0)
        assert wd.record_step(5.0)           # 5x the EMA
        assert wd.straggler_events == 1

    def test_ema_outlier_clamped(self):
        wd = StepWatchdog(ema_alpha=0.5, threshold=2.0)
        wd.record_step(1.0)
        wd.record_step(100.0)                # clamped into the EMA
        assert wd.ema < 5.0

    def test_hang_callback(self):
        fired = []
        wd = StepWatchdog(hang_timeout=0.2, on_hang=lambda: fired.append(1))
        time.sleep(0.5)
        wd.close()
        assert fired

    def test_preemption_flag(self):
        h = PreemptionHandler(signals=(signal.SIGUSR1,))
        assert not h.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert h.requested
        h.restore()


class TestDataPipeline:
    @pytest.mark.parametrize("hosts", [1, 2])
    def test_batches_equal_the_reference(self, hosts):
        kw = dict(vocab_size=128, global_batch=4, seq_len=16, seed=3,
                  n_hosts=hosts, host_id=hosts - 1)
        ours, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(
            JDataConfig(**kw))
        for _ in range(3):
            a, b = next(ours), next(ref)
            for k in ("tokens", "labels"):
                assert a[k].dtype == torch.int32
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        ours.load_state_dict({"step": 7})
        ref.load_state_dict({"step": 7})
        np.testing.assert_array_equal(next(ours)["tokens"].numpy(),
                                      np.asarray(next(ref)["tokens"]))
        assert ours.state_dict() == ref.state_dict() == {"step": 8}

    def test_state_resume(self):
        cfg = DataConfig(vocab_size=128, global_batch=4, seq_len=16)
        a = SyntheticLM(cfg)
        next(a)
        next(a)
        state = a.state_dict()
        expected = next(a)
        b = SyntheticLM(cfg)
        b.load_state_dict(state)
        assert torch.equal(next(b)["tokens"], expected["tokens"])

    def test_labels_shift(self):
        batch = next(SyntheticLM(DataConfig(vocab_size=128, global_batch=2,
                                            seq_len=16)))
        assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])


class TestLauncher:
    ARGV = ["--reduced", "--device", "cpu", "--steps", "6",
            "--global-batch", "4", "--seq-len", "16", "--log-every", "1"]

    def test_resume_equals_the_uninterrupted_run(self, tmp_path):
        """6 steps with a checkpoint at 3; then, from step 3 alone, a
        fresh process state resumes (params, optimizer, data stream) and
        its 3 losses equal the uninterrupted run's bit for bit."""
        ckpt = str(tmp_path / "run")
        full = launch_train.main(self.ARGV + ["--ckpt-dir", ckpt,
                                              "--ckpt-every", "3"])
        assert full.start == 0 and len(full.losses) == 6
        assert all(np.isfinite(full.losses))
        mgr = CheckpointManager(ckpt)
        assert mgr.all_steps() == [3, 6]
        os.rename(os.path.join(ckpt, "step_00000006"),
                  os.path.join(ckpt, "old_00000006"))
        resumed = launch_train.main(self.ARGV + ["--ckpt-dir", ckpt,
                                                 "--ckpt-every", "3"])
        assert resumed.start == 3
        assert resumed.losses == full.losses[3:]
        for a, b in zip(tree.leaves(resumed.params),
                        tree.leaves(full.params)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("flags", [["--mesh", "single"],
                                       ["--model-parallel", "2"]])
    def test_one_device_only(self, flags):
        """Without a world the run is one process: a pod mesh stops up
        front (it needs its 256 ranks); ``--model-parallel`` has nothing
        to split, and the run is the one without it (the reference's
        ``make_host_mesh`` on one device).  Meshes over a world:
        ``tests/test_torch_tensor_parallel.py``."""
        if flags[0] == "--mesh":
            with pytest.raises(SystemExit, match="256 ranks"):
                launch_train.main(self.ARGV + flags)
            return
        split = launch_train.main(self.ARGV + flags)
        assert split.losses == launch_train.main(self.ARGV).losses

    def test_no_card_no_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            launch_train.main(self.ARGV[:1] + self.ARGV[3:])

    @pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                      "recurrentgemma-2b", "rwkv6-7b"])
    def test_every_family_trains(self, arch):
        """The launcher trains the MoE, Griffin and RWKV-6 families on the
        plain torch route, K1 on the projections: 3 finite losses."""
        res = launch_train.main(["--arch", arch] + self.ARGV[:4] + ["3"]
                                + self.ARGV[5:])
        assert len(res.losses) == 3 and all(np.isfinite(res.losses))

    def test_whisper_is_refused_up_front(self):
        """The stream has no audio frames (nor has the reference's): the
        launcher stops before a step with the reason, not a KeyError."""
        with pytest.raises(ValueError, match="audio_embeds"):
            launch_train.main(["--arch", "whisper-tiny"] + self.ARGV)
