"""The training side's differentiable pieces against the JAX reference,
live, on the CPU: the norm Function (its custom backward against
``jax.vjp`` of repro's ``_norm_core``), the chunked cross-entropy, the
chunked attention's gradients at 1024 tokens, and the RG-LRU scan's
Function (its reverse-time backward against autograd through ``ref.py``
and against ``jax.grad`` of repro's ``associative_scan``).

Tolerances: fp32 values and gradients within 1e-5 of the case's largest
magnitude (sums run in other orders); bf16 norms within
``BF16_REL_TOL`` (4 bf16 ulps) of the largest value, since both sides
round every op to 8 mantissa bits at different points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import losses as jlosses
from repro.models import recurrent as jrec
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import losses as tlosses
from repro_torch.models import recurrent as trec

FP32_REL_TOL = 1e-5
BF16_REL_TOL = 4 * 2.0 ** -8


def _close(port, ref, rel, what=""):
    port = np.asarray(port.detach().float() if torch.is_tensor(port)
                      else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"{what}: err {err} > {rel} * {scale}"


def _t(a, dtype=None, grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_function_matches_reference_vjp(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3 + 0.5
    scale = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    bias = 0.1 * rng.standard_normal(64).astype(np.float32)
    dy = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def jfn(x_, s_, b_):
        p = {"scale": s_}
        if kind == "layernorm":
            p["bias"] = b_
        return jl.apply_norm(p, x_, kind)

    jx = jnp.asarray(x, jdt)
    jout, vjp = jax.vjp(jfn, jx, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(dy, jdt))

    tdt = getattr(torch, dtype)
    tx = _t(x, tdt, grad=True)
    ts, tb = _t(scale, grad=True), _t(bias, grad=True)
    p = {"scale": ts}
    if kind == "layernorm":
        p["bias"] = tb
    out = tl.apply_norm(p, tx, kind)
    assert out.dtype == tdt
    out.backward(_t(dy, tdt))
    rel = FP32_REL_TOL if dtype == "float32" else BF16_REL_TOL
    _close(out, jout, rel, "out")
    _close(tx.grad, jdx, rel, "dx")
    assert tx.grad.dtype == tdt and ts.grad.dtype == torch.float32
    _close(ts.grad, jds, rel, "dscale")
    if kind == "layernorm":
        _close(tb.grad, jdb, rel, "dbias")
    else:
        assert tb.grad is None


def test_norm_function_forward_is_the_serving_forward():
    """Under no_grad the Function's forward is the formula it replaced,
    bit for bit, so serving's tokens do not change."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 5, 32), generator=gen).to(torch.bfloat16)
    scale = torch.randn(32, generator=gen)
    bias = torch.randn(32, generator=gen)
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": scale} if kind == "rmsnorm" else \
            {"scale": scale, "bias": bias}
        mean, inv = tl._row_stats(x, kind)
        if kind == "rmsnorm":
            expect = x * inv.to(x.dtype) * scale.to(x.dtype)
        else:
            expect = ((x - mean.to(x.dtype)) * inv.to(x.dtype)
                      * scale.to(x.dtype) + bias.to(x.dtype))
        with torch.no_grad():
            assert torch.equal(tl.apply_norm(p, x, kind), expect)


@pytest.mark.parametrize("chunk", [8, 12])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_value_and_grads_match_reference(chunk, masked):
    """Chunks that divide S (8 of 32) and that do not (12: padded with
    masked positions), with and without a loss mask."""
    rng = np.random.default_rng(chunk + masked)
    b, s, d, v = 2, 32, 16, 50
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = 0.3 * rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None

    def jfn(h_, w_):
        return jlosses.chunked_softmax_xent(
            h_, w_, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), chunk=chunk)

    (jloss, jn), (jdh, jdw) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                           jnp.asarray(head))
    th, tw = _t(hidden, grad=True), _t(head, grad=True)
    loss, n = tlosses.chunked_softmax_xent(
        th, tw, torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask), chunk=chunk)
    loss.backward()
    assert float(n) == float(jn)
    _close(loss, jloss, FP32_REL_TOL, "loss")
    _close(th.grad, jdh, FP32_REL_TOL, "d hidden")
    _close(tw.grad, jdw, FP32_REL_TOL, "d head")


def test_chunked_attention_grads_match_reference_at_1024():
    """Training at 1024 tokens takes ``attention_chunked`` (the kv step
    checkpointed); its gradients equal ``jax.vjp`` of repro's."""
    cfg = get_smoke_config("qwen2-0.5b")
    fn = tattn.select_attention(cfg, 1024)
    assert fn.func is tattn.attention_chunked
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 1024, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1024, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1024, 2, 8)).astype(np.float32)
    dy = rng.standard_normal((1, 1024, 4, 8)).astype(np.float32)
    jout, vjp = jax.vjp(
        lambda a, b_, c: jattn.attention_chunked(a, b_, c, q_block=512,
                                                 kv_block=1024),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dy))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv, causal=True)
    out.backward(_t(dy))
    _close(out, jout, FP32_REL_TOL, "out")
    for t, j, name in zip((tq, tk, tv), jgrads, "qkv"):
        _close(t.grad, j, FP32_REL_TOL, f"d{name}")


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_scan_function_grads_match_autograd_through_ref(xdtype):
    """da, dx of the Function (the reverse-time scan, ``ref.py`` both
    ways on the CPU) against torch autograd through ``ref.py``; the plain
    version's calls are counted as no launch, either way."""
    gen = torch.Generator().manual_seed(4)
    a = (0.5 + 0.5 * torch.rand((2, 37, 24), generator=gen))
    x = torch.randn((2, 37, 24), generator=gen).to(xdtype)
    g = torch.randn((2, 37, 24), generator=gen).to(xdtype)
    a1, x1 = a.clone().requires_grad_(), x.clone().requires_grad_()
    rglru_ops.reset_launch_counts()
    h = rglru_scan(a1, x1)
    assert h.dtype == xdtype and h.grad_fn is not None
    da, dx = torch.autograd.grad(h, (a1, x1), g)
    assert rglru_ops.LAUNCHES == {"rglru_scan": 0}
    assert rglru_ops.BACKWARD_LAUNCHES == {"scan_backward": 0}
    a2, x2 = a.clone().requires_grad_(), x.clone().requires_grad_()
    ea, ex = torch.autograd.grad(rglru_scan_ref(a2, x2), (a2, x2), g)
    assert da.dtype == torch.float32 and dx.dtype == xdtype
    rel = FP32_REL_TOL if xdtype == torch.float32 else BF16_REL_TOL
    _close(da, ea.float().numpy(), rel, "da")
    _close(dx, ex.float().numpy(), rel, "dx")


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_scan_grads_match_reference_associative_scan(with_state):
    """The block-level scan (gates, the carry fold of ``h0``, the scan)
    differentiated in both packages: every gate weight, u and h0."""
    rng = np.random.default_rng(5)
    lru = 16
    p = {"w_rec_gate": 0.3 * rng.standard_normal((lru, lru)),
         "b_rec_gate": 0.1 * rng.standard_normal(lru),
         "w_input_gate": 0.3 * rng.standard_normal((lru, lru)),
         "b_input_gate": 0.1 * rng.standard_normal(lru),
         "lam": rng.uniform(0.5, 4.0, lru)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    u = rng.standard_normal((2, 21, lru)).astype(np.float32)
    h0 = rng.standard_normal((2, lru)).astype(np.float32)
    dy = rng.standard_normal((2, 21, lru)).astype(np.float32)

    def jfn(pp, uu, hh):
        return jrec.rglru_scan(pp, uu, hh if with_state else None)

    jout, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, p), jnp.asarray(u),
                        jnp.asarray(h0))
    jp, ju, jh = vjp(jnp.asarray(dy))
    tp = {k: _t(v, grad=True) for k, v in p.items()}
    tu, th = _t(u, grad=True), _t(h0, grad=True)
    out = trec.rglru_scan(tp, tu, th if with_state else None)
    out.backward(_t(dy))
    _close(out, jout, FP32_REL_TOL, "h")
    _close(tu.grad, ju, FP32_REL_TOL, "du")
    for k in p:
        _close(tp[k].grad, jp[k], FP32_REL_TOL, f"d{k}")
    if with_state:
        _close(th.grad, jh, FP32_REL_TOL, "dh0")
    else:
        assert th.grad is None
