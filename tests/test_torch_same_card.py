"""Collectives among ranks that share one card (``distributed.same_card``).

On the CPU: the staging protocol in a gloo world of 4 CPU ranks, each
rank's buffer a shared host file standing in for its card memory that
the others map (``_own``, ``_peer`` and ``_sync`` replaced), with a
buffer of 4 KiB so that a tensor takes many rounds: ``all_gather`` and
``all_reduce`` (sum in group rank order, max) over the world and over
each axis of a (2, 2) mesh, in fp32, bf16 and int32, against what each
must give, computed on each rank from every rank's seeded input.

On the card (``-m sm90``; elsewhere it skips): a world of 4 ranks on the
one card, each collective of ``collectives`` on CUDA tensors the same
way, ``reduce_scatter`` too, at a size that takes more than one round of
the real buffer; many small calls leave no memory behind.
    PYTHONPATH=src python -m pytest -m sm90 tests/test_torch_same_card.py
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_HOST_PROG = textwrap.dedent("""
    import os
    import sys
    sys.path.insert(0, sys.argv[1])
    import torch

    from repro_torch.launch.mesh import make_mesh, run_world

    DTYPES = (torch.float32, torch.bfloat16, torch.int32)
    STAGE = 4096


    def stand_in(tmp, r):
        from repro_torch.distributed import same_card
        own = {}

        def buffer(members):
            if members not in own:
                path = os.path.join(
                    tmp, f"stage{r}-" + "-".join(map(str, members)))
                own[members] = (torch.from_file(
                    path, shared=True, size=2 * STAGE, dtype=torch.uint8),
                    path.encode().ljust(64, b"\\0"))
            return own[members]

        same_card.STAGE_BYTES = STAGE
        same_card._own = buffer
        same_card._peer = lambda h: torch.from_file(
            h.rstrip(b"\\0").decode(), shared=True, size=2 * STAGE,
            dtype=torch.uint8)
        same_card._sync = lambda: None
        return same_card


    def seeded(rank, numel, dtype, salt):
        g = torch.Generator().manual_seed(1000 * salt + rank)
        if dtype.is_floating_point:
            return torch.randn(numel, generator=g).to(dtype)
        return torch.randint(-1000, 1000, (numel,), generator=g,
                             dtype=dtype)


    def held(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: max |diff| "
                                 f"{(got.double() - want.double()).abs().max()}")


    def rank_main(world, tmp):
        torch.set_num_threads(1)
        r, n = world.rank, world.size
        sc = stand_in(tmp, r)
        mesh = make_mesh((2, 2), ("data", "model"))
        groups = {"world": (None, list(range(n))),
                  "data": (mesh.group("data"), [r % 2, r % 2 + 2]),
                  "model": (mesh.group("model"),
                            [r // 2 * 2, r // 2 * 2 + 1])}
        for salt, dtype in enumerate(DTYPES):
            for name, (group, members) in groups.items():
                for numel in (1, 1000, 3 * STAGE // 4 + 5, 5 * STAGE):
                    xs = [seeded(m, numel, dtype, salt) for m in members]
                    mine = xs[members.index(r)]
                    tag = f"{name} {dtype} {numel}"
                    parts = [torch.empty_like(mine) for _ in members]
                    sc.all_gather(mine, parts, group)
                    held(f"all_gather {tag}", torch.cat(parts),
                         torch.cat(xs))
                    want = xs[0].clone()
                    for x in xs[1:]:
                        want += x
                    got = mine.clone()
                    sc.all_reduce(got, group)
                    held(f"all_reduce {tag}", got, want)
                    got = mine.clone()
                    sc.all_reduce(got, group, op="max")
                    held(f"all_reduce max {tag}", got,
                         torch.stack(xs).amax(0))
        x = torch.ones(3, requires_grad=True)
        sc.all_reduce(x, None)
        held("a leaf that requires grad", x.detach(), torch.full((3,), 4.0))
        assert x._version == 0 and x.requires_grad
        open(os.path.join(tmp, f"rank{r}.ok"), "w").close()


    if __name__ == "__main__":
        run_world(rank_main, 4, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")

_PROG = textwrap.dedent("""
    import os
    import sys
    sys.path.insert(0, sys.argv[1])
    import torch

    from repro_torch.launch.mesh import make_mesh, run_world

    DTYPES = (torch.float32, torch.bfloat16, torch.int32)


    def seeded(rank, numel, dtype, salt):
        g = torch.Generator(device="cuda").manual_seed(1000 * salt + rank)
        if dtype.is_floating_point:
            return torch.randn(numel, device="cuda", generator=g).to(dtype)
        return torch.randint(-1000, 1000, (numel,), device="cuda",
                             generator=g, dtype=dtype)


    def held(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: max |diff| "
                                 f"{(got.double() - want.double()).abs().max()}")


    def rank_main(world, tmp):
        from repro_torch.distributed import collectives, same_card
        assert world.one_card, world
        r, n = world.rank, world.size
        mesh = make_mesh((2, 2), ("data", "model"))
        groups = {"world": (None, list(range(n))),
                  "data": (mesh.group("data"),
                           [r % 2, r % 2 + 2]),
                  "model": (mesh.group("model"),
                            [r // 2 * 2, r // 2 * 2 + 1])}
        big = same_card.STAGE_BYTES // 4 + 4096     # two rounds in fp32
        for salt, dtype in enumerate(DTYPES):
            for name, (group, members) in groups.items():
                for numel in (1, 4 * 1024 + 4, big):
                    if numel == big and (name != "world"
                                         or dtype != torch.float32):
                        continue
                    xs = [seeded(m, numel, dtype, salt) for m in members]
                    mine = xs[members.index(r)]
                    tag = f"{name} {dtype} {numel}"
                    held(f"all_gather {tag}",
                         collectives.all_gather(mine, group), torch.cat(xs))
                    want = xs[0].clone()
                    for x in xs[1:]:
                        want += x
                    got = mine.clone()
                    held(f"all_reduce {tag}",
                         collectives.all_reduce(got, group), want)
                    got = mine.clone()
                    held(f"all_reduce max {tag}",
                         collectives.all_reduce(got, group, op="max"),
                         torch.stack(xs).amax(0))
                    if numel % len(members) == 0:
                        k = members.index(r)
                        c = numel // len(members)
                        held(f"reduce_scatter {tag}",
                             collectives.reduce_scatter(mine, group),
                             want[k * c:(k + 1) * c])
        # a 2-D gather along its second dim
        x = seeded(r, 6 * 10, torch.float32, 9).view(6, 10)
        held("all_gather dim 1", collectives.all_gather(x, None, dim=1),
             torch.cat([seeded(m, 60, torch.float32, 9).view(6, 10)
                        for m in range(n)], 1))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for i in range(200):
            y = seeded(r, 1000, torch.float32, 11) * i
            collectives.all_gather(y, mesh.group("model"))
            collectives.all_reduce(y, mesh.group("data"))
            del y
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - base
        if left:
            raise AssertionError(f"200 calls left {left} B allocated")
        open(os.path.join(tmp, f"rank{r}.ok"), "w").close()


    if __name__ == "__main__":
        run_world(rank_main, 4, (sys.argv[2],),
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _run(prog_text, tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(prog_text)
    res = subprocess.run([sys.executable, str(prog), _SRC, str(tmp_path),
                          "240"], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert sorted(p.name for p in tmp_path.glob("rank*.ok")) == [
        f"rank{r}.ok" for r in range(4)]


def test_protocol_on_host_buffers(tmp_path):
    _run(_HOST_PROG, tmp_path)


@pytest.mark.sm90
def test_collectives_on_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() != 1:
        pytest.skip("the ranks must share the host's one card")
    _run(_PROG, tmp_path)
