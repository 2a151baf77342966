"""The port's paged KV residency model (``repro_torch.serving.kvcache``)
against the reference's: the same seeded operation sequences give the
same block states, evictions, refill bytes, counters and trace digests,
and ``kv_bytes_per_token`` / ``refill_cycles`` give the same numbers.
"""

import random

import pytest

pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.config import CASE_STUDY as J_UNIT        # noqa: E402
from repro.core.hardware import SHUTTLE as J_SHUTTLE      # noqa: E402
from repro.serving import kvcache as jkv                   # noqa: E402
from repro_torch.configs.registry import get_config       # noqa: E402
from repro_torch.core.config import CASE_STUDY            # noqa: E402
from repro_torch.core.hardware import SHUTTLE             # noqa: E402
from repro_torch.serving import kvcache as tkv             # noqa: E402


def _ops(seed, n=120, n_requests=5):
    """A seeded sequence of (op, rid, n_tokens, t) the two caches replay."""
    rng = random.Random(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += rng.random()
        op = rng.choice(("append", "append", "touch", "release"))
        out.append((op, rng.randrange(n_requests), rng.randint(1, 9), t))
    return out


def _replay(mod, ops, **kw):
    c = mod.PagedKVCache(**kw)
    log = []
    for op, rid, n, t in ops:
        try:
            if op == "append":
                r = c.append(rid, n, t)
            elif op == "touch":
                r = c.ensure_resident(rid, t)
            else:
                r = c.release(rid, t)
        except mod.KVPoolExhausted as e:
            r = ("exhausted", str(e))
        log.append((op, repr(r), c.free_slots(), c.allocated_slots(),
                    repr(c.blocks_of(rid)), c.tokens_of(rid),
                    c.residency(rid), c.refill_bytes(rid)))
    return c, log


@pytest.mark.parametrize("policy", ("lru", "recompute"))
@pytest.mark.parametrize("seed", (0, 1, 7))
def test_seeded_sequences_replay_identically(policy, seed):
    kw = dict(hot_blocks=6, block_tokens=4, kv_bytes_per_token=96.0,
              policy=policy, seed=seed)
    jc, jlog = _replay(jkv, _ops(seed), **kw)
    tc, tlog = _replay(tkv, _ops(seed), **kw)
    assert tlog == jlog
    assert tc.counters == jc.counters
    assert tc.trace == jc.trace
    assert tc.trace_digest() == jc.trace_digest()
    assert tc.counters["evictions"] > 0 and tc.counters["refills"] > 0


def test_pool_exhaustion_and_validation_match():
    for mod in (jkv, tkv):
        with pytest.raises(ValueError, match="eviction policy"):
            mod.PagedKVCache(hot_blocks=4, policy="mru")
        c = mod.PagedKVCache(hot_blocks=2, block_tokens=4)
        with pytest.raises(mod.KVPoolExhausted):
            c.append(0, 12, 0.0)
    assert tkv.EVICTION_POLICIES == jkv.EVICTION_POLICIES
    assert tkv.RECOMPUTE_REFILL_FACTOR == jkv.RECOMPUTE_REFILL_FACTOR


@pytest.mark.parametrize("arch", ("yi-6b", "gemma2-2b", "olmoe-1b-7b"))
def test_bytes_and_refill_cycles_equal(arch):
    j, t = j_get_config(arch), get_config(arch)
    for dtype_bytes in (1.0, 2.0):
        assert (tkv.kv_bytes_per_token(t, dtype_bytes)
                == jkv.kv_bytes_per_token(j, dtype_bytes))
    for nbytes in (0.0, 4096.0, 3.5e6):
        for units in (1, 4):
            assert (tkv.refill_cycles(nbytes, CASE_STUDY, SHUTTLE,
                                      units=units)
                    == jkv.refill_cycles(nbytes, J_UNIT, J_SHUTTLE,
                                         units=units))
