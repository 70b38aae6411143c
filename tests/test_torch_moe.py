"""The port's MoE FFN against the JAX reference's, live, on the reference's
own weights (CPU, fp32).

granite-moe-1b-a400m's smoke config (8 experts top-2, no shared expert)
and deepseek-moe-16b's (8 experts top-2, 2 shared, layer 0 dense), at
capacity factor 8.0 (no pair dropped) and 0.3 (pairs dropped), over
three input seeds: outputs and the auxiliary loss within 1e-5, the top-k
expert ids exactly.  The dense oracles agree as well, and a row's output
does not depend on its batch neighbours, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.models import moe as tmoe
from repro_torch.models.params import from_numpy
from tests.test_torch_engine import connect_family
from tests.test_torch_model import port_config

ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _moe(arch, cf):
    """(JAX cfg, port cfg, JAX params, port params) of the first MoE
    layer (the first layer of the stacked body), capacity factor cf."""
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype="float32")
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jp["decoder"]["body"][0]["moe"])
    return jcfg, port_config(jcfg), jp, from_numpy(jax.device_get(jp))


def _x(cfg, seed, b=3, s=64):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cf", [8.0, 0.3], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, cf, seed):
    jcfg, tcfg, jp, tp = _moe(arch, cf)
    x = _x(tcfg, seed)
    j_out, j_aux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    t_out, t_aux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    _close(t_out, j_out)
    _close(t_aux, j_aux)
    # routing: the same experts, in the same order
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"])
    _, j_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), tcfg.moe.top_k)
    _, _, t_idx = tmoe._route(tp, torch.from_numpy(x), tcfg.moe)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    cap = tmoe._capacity(64, tcfg.moe)
    assert cap == jmoe._capacity(64, jcfg.moe)
    counts = np.stack([np.bincount(r.reshape(-1), minlength=8)
                       for r in np.asarray(j_idx)])
    # cf 0.3 drops pairs (an expert over its capacity), cf 8.0 none
    assert (counts.max() > cap) == (cf < 1), (counts.max(), cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracle_matches_reference(arch):
    """The capacity-free oracles agree, and without drops apply_moe
    equals its oracle."""
    jcfg, tcfg, jp, tp = _moe(arch, 8.0)
    x = _x(tcfg, 3)
    j_out, j_aux = jmoe.apply_moe_reference(jp, jnp.asarray(x), jcfg)
    t_out, t_aux = tmoe.apply_moe_reference(tp, torch.from_numpy(x), tcfg)
    _close(t_out, j_out)
    _close(t_aux, j_aux)
    out, aux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    torch.testing.assert_close(out, t_out, rtol=0, atol=TOL)
    torch.testing.assert_close(aux, t_aux, rtol=0, atol=TOL)


@pytest.mark.parametrize("cf", [8.0, 0.3], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rows_are_independent(arch, cf):
    """Per-row dispatch: changing row 1 leaves row 0's output bit-equal
    (capacity is per row; no token pools across rows)."""
    _, tcfg, _, tp = _moe(arch, cf)
    x = torch.from_numpy(_x(tcfg, 4, b=2))
    y = x.clone()
    y[1] = torch.from_numpy(_x(tcfg, 5, b=1))[0]
    out_x, _ = tmoe.apply_moe(tp, x, tcfg)
    out_y, _ = tmoe.apply_moe(tp, y, tcfg)
    assert torch.equal(out_x[0], out_y[0])
    assert not torch.equal(out_x[1], out_y[1])
    alone, _ = tmoe.apply_moe(tp, x[:1], tcfg)
    assert torch.equal(alone[0], out_x[0])


def test_decode_shape_capacity():
    """A decode step (s = 1) runs every expert on 8 slots a row: the
    capacity floor, as the reference's."""
    for arch in ARCHS:
        jcfg, tcfg, _, tp = _moe(arch, 1.25)
        assert tmoe._capacity(1, tcfg.moe) == jmoe._capacity(1, jcfg.moe) == 8
        out, aux = tmoe.apply_moe(tp, torch.from_numpy(_x(tcfg, 6, 4, 1)),
                                  tcfg)
        assert out.shape == (4, 1, tcfg.d_model) and aux.dim() == 0


# ----- serving through connect() ---------------------------------------------

@pytest.mark.parametrize("horizon,pages,buckets", [
    (1, False, "auto"), (8, False, "auto"), (1, True, "auto"),
    (8, True, "auto"), (8, False, None)],
    ids=["K1", "K8", "K1-pages4", "K8-pages4", "K8-exact"])
@pytest.mark.parametrize("arch", ARCHS)
def test_connect_matches_reference(arch, horizon, pages, buckets):
    """The smoke config at fp32 through connect(): bucketed admission
    (and exact-length), the per-step loop and the fused horizon, the
    contiguous cache and a tight shared page pool (level 4, 8 pages)
    that defers admissions.  Tokens and compile_count() equal the
    reference's."""
    got, t_count, eng = connect_family("port", arch, horizon, pages, buckets)
    expect, j_count, j_eng = connect_family("repro", arch, horizon, pages,
                                            buckets)
    assert got == expect
    assert t_count == j_count
    assert eng.paged == pages
    assert eng.stats["prefills"] == j_eng.stats["prefills"]
    if pages:
        assert eng.stats["page_deferrals"] == j_eng.stats["page_deferrals"]
