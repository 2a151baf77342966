"""Sequence parallelism for every family, trained: one AdamW step of
RecurrentGemma (Griffin), RWKV-6, Whisper (its frames sharded on 4 ranks
and whole on 8), OLMoE (tokens overflowing), internvl2 and yi-6b with
leaves the rules keep whole, under the reference's ``{"seq": "model"}``
rules, against the reference's step jitted under the same mesh and
rules.

The worlds are ``tests/test_torch_seq_parallel.py``'s (``run_worlds``),
run here for the train steps alone: the reference on 8 forced host
devices, the port in a gloo world of 8 CPU ranks through
``training.train_step.make_train_step``.  Reduced configurations in
fp32, remat "full", 2 microbatches of 4 x 16 tokens, eps 1e-2: the loss
within 1e-5 relative and every gathered leaf (parameters and first
moment) within ``TOL_STEP`` of its max, Griffin's decay leaves within
``TOL_EXPM1_LEAVES`` (``tests/test_torch_rec_mesh.py``'s limits and
reasons).
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_seq_parallel as sp                      # noqa: E402
from repro_torch.configs import registry as reg           # noqa: E402
from repro_torch.models.base import family_module         # noqa: E402

#: case -> (arch, (data, model), variant, rules)
TRAIN = {
    "griffin/1x4": ("recurrentgemma-2b", (1, 4), "base", "seq"),
    "rwkv/2x2": ("rwkv6-7b", (2, 2), "base", "seq"),
    "whisper/1x4": ("whisper-tiny", (1, 4), "base", "seq"),
    "whisper/1x8/frames_whole": ("whisper-tiny", (1, 8), "ctx20", "seq"),
    "olmoe/2x2": ("olmoe-1b-7b", (2, 2), "cap05", "seq"),
    "internvl/1x4": ("internvl2-1b", (1, 4), "base", "seq"),
    "yi/attn_whole/1x4": ("yi-6b", (1, 4), "base", "attn_whole"),
    "yi/vocab_whole/1x4": ("yi-6b", (1, 4), "base", "vocab_whole"),
    # the recurrent blocks and mixes, and the experts, held whole: every
    # rank runs them over the gathered stream and keeps its rows
    "griffin/attn_whole/1x4": ("recurrentgemma-2b", (1, 4), "base",
                               "attn_whole"),
    "rwkv/attn_whole/1x4": ("rwkv6-7b", (1, 4), "base", "attn_whole"),
    "olmoe/experts_whole/1x4": ("olmoe-1b-7b", (1, 4), "cap05",
                                "experts_whole"),
}
#: a trained leaf's limit, of its max, and Griffin's RG-LRU decay leaves
#: against the reference (``tests/test_torch_rec_mesh.py``'s TOL_STEP and
#: EXPM1_LEAVES, with their reasons)
TOL_STEP = {"rwkv6-7b": 1e-4}
EXPM1_LEAVES, TOL_EXPM1_LEAVES = ("w_rec_gate", "b_rec_gate",
                                  "lambda_p"), 1e-3


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The train steps' worlds (``test_torch_seq_parallel.run_worlds``)."""
    return sp.run_worlds(str(tmp_path_factory.mktemp("seq_parallel_train")),
                         train=TRAIN)


def _limits(arch):
    """Each leaf's limit against the reference, in tree order."""
    from repro_torch.core import tree
    cfg = reg.get_config(arch, reduced=True)
    like = family_module(cfg).init(cfg, None, "meta")
    tol = TOL_STEP.get(arch, 1e-5)
    return [TOL_EXPM1_LEAVES if path[-1] in EXPM1_LEAVES else tol
            for path, _ in tree.flatten_with_path(like)]


class TestTrainedUnderSequenceParallelism:
    @pytest.mark.parametrize("case", list(TRAIN))
    def test_step_matches_reference_meshed(self, worlds, case):
        """Every rank's step, gathered, against the reference's step
        jitted under the same mesh and rules: the loss and each updated
        parameter and first moment."""
        ref, ranks = worlds
        arch, shape, _, _ = TRAIN[case]
        limits = _limits(arch)
        loss = float(ref[f"{case}/loss"])
        for out in sp._ranks_of(ranks, shape):
            assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
            for kind in ("param", "mu"):
                rels = [sp._rel(a, b) for a, b in zip(
                    sp._leaves(out, case, kind), sp._leaves(ref, case, kind))]
                assert len(rels) == len(limits)
                assert all(r <= t for r, t in zip(rels, limits)), max(
                    zip(rels, limits), key=lambda x: x[0] / x[1])
