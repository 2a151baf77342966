"""The port's transformer configurations against the reference's.

Every ``ArchConfig`` field of gemma2-2b, gemma2-27b, internvl2-1b and
deepseek-67b, full and reduced, equals the reference's (dtypes by name;
the default route is the port's ``"kernel"`` where the reference's is
``"xla"``, as for every ported config); reduced gemma2-27b and
deepseek-67b run forward, prefill and two decode steps on the
reference's weights within rtol/atol 1e-4 in fp32, as
tests/test_torch_transformer.py holds yi-6b.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro_torch.configs.registry import (ALL_ARCHS,      # noqa: E402
                                          get_config)
from repro_torch.models import transformer as tt         # noqa: E402
from repro_torch.models.base import ArchConfig           # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402

NEW = ("gemma2-2b", "gemma2-27b", "internvl2-1b", "deepseek-67b")
B = 2


@pytest.mark.parametrize("reduced", (False, True), ids=("full", "reduced"))
@pytest.mark.parametrize("arch", NEW)
def test_fields_equal_the_reference(arch, reduced):
    jcfg = j_get_config(arch, reduced=reduced)
    tcfg = get_config(arch, reduced=reduced)
    for f in dataclasses.fields(ArchConfig):
        ours, ref = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "kv_cache_dtype"):
            assert str(ours).removeprefix("torch.") == jnp.dtype(ref).name
        elif f.name == "backend":
            assert (ours, ref) == ("kernel", "xla")
        else:
            assert ours == ref, f.name


def test_registry_holds_every_reference_arch_but_whisper():
    """Since the encoder-decoder family is ported, every reference arch,
    whisper-tiny included: its fields, full and reduced, equal the
    reference's (the encoder-decoder sub-config field by field)."""
    from repro.configs.registry import ALL_ARCHS as J_ARCHS
    assert set(J_ARCHS) == set(ALL_ARCHS)
    for reduced in (False, True):
        jcfg = j_get_config("whisper-tiny", reduced=reduced)
        tcfg = get_config("whisper-tiny", reduced=reduced)
        assert dataclasses.asdict(tcfg.encdec) == \
            dataclasses.asdict(jcfg.encdec)
        for f in dataclasses.fields(ArchConfig):
            if f.name not in ("dtype", "kv_cache_dtype", "backend",
                              "encdec"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                    f.name
    with pytest.raises(KeyError, match="whisper-base"):
        get_config("whisper-base")


def _perturbed(params, rng):
    """Norm weights made non-trivial (init leaves them 0/1)."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name.endswith("norm"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ("gemma2-27b", "deepseek-67b"))
def test_reduced_forward_prefill_decode_match_jax(arch):
    jcfg = j_get_config(arch, reduced=True).with_(
        remat="none", dtype=jnp.float32, kv_cache_dtype=jnp.float32)
    tcfg = get_config(arch, reduced=True).with_(
        dtype=torch.float32, kv_cache_dtype=torch.float32)
    rng = np.random.default_rng(5)
    jmod = j_family(jcfg)
    jparams = _perturbed(jmod.init(jcfg, jax.random.PRNGKey(2)), rng)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    s = 20                                  # past gemma2's reduced window 16
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, s))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    _close(tt.forward(tcfg, tparams, tb), jmod.forward(jcfg, jparams, jb))
    jcache = jmod.init_cache(jcfg, B, s + 2)
    tcache = tt.init_cache(tcfg, B, s + 2)
    jl, jcache = jmod.prefill(jcfg, jparams, jb, jcache)
    tl, tcache = tt.prefill(tcfg, tparams, tb, tcache)
    _close(tl, jl)
    for i in range(2):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tok),
                                      jcache, s + i)
        tl, tcache = tt.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, s + i)
        _close(tl, jl)
