"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), forward
only.

mLSTM, stabilised exponential gating (Beck et al. 2024, arXiv:2405.04517):
    m_t = max(f~_t + m_{t-1}, i~_t)
    i'  = exp(i~ - m_t);   f' = exp(f~ + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' (v_t k_t^T)
    n_t = f' n_{t-1} + i' k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

sLSTM keeps per-head scalar cells with recurrent block-diagonal weights,
a true recurrence, scanned step by step.

The port of ``repro.models.xlstm``, op for op, with the reference's dtype
switch: from ``t >= 2 * MLSTM_CHUNK`` tokens the mLSTM input stream drops
to the compute dtype (fp32 accumulation in the core), and the chunkwise
core runs when ``t`` is also a multiple of ``MLSTM_CHUNK``.  Where the
reference reads a weight in fp32 (the q/k/v and gate projections of the
fp32 stream, the gate biases, the group norms' scales, every sLSTM cell
weight), its spec says ``keep_fp32``, so ``Model.prepare_params`` keeps
it in fp32 at every compute dtype, as the reference reads its fp32
params.  The reference's ``lax.scan`` over time is a Python loop here.

Caches are updated IN PLACE, as the RG-LRU block's are: ``conv``, ``c``,
``n`` and ``m`` for mLSTM, ``c``, ``n``, ``h`` and ``m`` for sLSTM.  A
decode step (T == 1) takes ``step_active`` (0-d bool tensor): off, every
state leaf stays as it was (a step the reference's early-exiting horizon
would not run), so a captured graph's buffers keep their addresses and
their values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import compute_dtype, rms_group_norm
from repro_torch.models.params import ParamSpec
from repro_torch.models.recurrent import causal_conv1d

MLSTM_CHUNK = 256
M_INIT = -1e30                  # the stabiliser's start: no history


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig):
    d = cfg.d_model
    du = 2 * d
    h = cfg.n_xlstm_heads
    bs = cfg.xlstm_qkv_blocksize
    if bs:
        qkv = lambda: ParamSpec((du // bs, bs, bs),
                                ("lru", "qkv_block", "qkv_block_in"),
                                keep_fp32=True)
    else:
        qkv = lambda: ParamSpec((du, du), ("lru", "lru_in"), keep_fp32=True)
    return {
        "w_up": ParamSpec((d, 2 * du), ("embed", "lru")),
        "conv": ParamSpec((cfg.conv1d_width, du), ("conv", "lru"),
                          init="normal", scale=0.1),
        "wq": qkv(),
        "wk": qkv(),
        "wv": qkv(),
        "w_igate": ParamSpec((du, h), ("lru", "heads_x"), init="normal",
                             scale=0.02, keep_fp32=True),
        "b_igate": ParamSpec((h,), ("heads_x",), init="zeros",
                             keep_fp32=True),
        "w_fgate": ParamSpec((du, h), ("lru", "heads_x"), init="normal",
                             scale=0.02, keep_fp32=True),
        "b_fgate": ParamSpec((h,), ("heads_x",), init="ones",
                             keep_fp32=True),
        "gn_scale": ParamSpec((du,), ("lru",), init="ones", keep_fp32=True),
        "skip": ParamSpec((du,), ("lru",), init="ones"),
        "w_down": ParamSpec((du, d), ("lru", "embed")),
    }


def _zero_state(b, nh, dh, device):
    return (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, nh, dh), dtype=torch.float32, device=device),
            torch.full((b, nh), M_INIT, dtype=torch.float32, device=device))


def _mlstm_scan(q, k, v, igate, fgate, c0=None, n0=None, m0=None):
    """q/k/v: (B, T, H, dh) (fp32, or the compute dtype on the long
    stream); igate/fgate: (B, T, H) fp32 pre-activations.  -> h (B, T, H,
    dh) fp32 and the final (C, n, m)."""
    b, t, nh, dh = q.shape
    c, n, m = (_zero_state(b, nh, dh, q.device) if c0 is None
               else (c0, n0, m0))
    logf = F.logsigmoid(fgate)
    hs = []
    for s in range(t):
        qt, kt, vt = q[:, s], k[:, s], v[:, s]
        it, lf = igate[:, s], logf[:, s]
        m_new = torch.maximum(lf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])              # (B,H,dv,dk)
        n = f_p[..., None] * n + i_p[..., None] * kt
        qf = qt.float()
        num = (c @ qf[..., None])[..., 0]
        den = torch.maximum((n * qf).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (c, n, m)


def _mlstm_chunkwise(q, k, v, igate, fgate, chunk: int = MLSTM_CHUNK,
                     c0=None, n0=None, m0=None):
    """Chunkwise-parallel mLSTM, equal to :func:`_mlstm_scan` up to
    rounding.  Within a chunk of length L the outputs come from (L, L)
    decay matrices; across chunks only the (C, n, m) state is carried.
    The products run in fp32 from the (possibly compute-dtype) inputs,
    as the reference's ``preferred_element_type=float32``.

    Stabilised, state scaled by exp(-m):
      b_i   = sum_{j<=i} log f_j            (intra-chunk cumulative decay)
      g_i   = cummax_{j<=i} (i~_j - b_j)
      m_i   = b_i + max(m0, g_i)            (running stabiliser)
      h_i   = exp(m0 + b_i - m_i) C0 q_i
              + sum_{j<=i} exp(b_i - b_j + i~_j - m_i) v_j (k_j . q_i)
      den_i = the same weights on (n0, k_j), max(|.|, exp(-m_i))
    """
    b, t, nh, dh = q.shape
    l = min(chunk, t)
    assert t % l == 0, (t, l)
    c, n, m = (_zero_state(b, nh, dh, q.device) if c0 is None
               else (c0, n0, m0))
    # (B, T, H[, dh]) -> (B, H, T[, dh])
    qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))
    igs = igate.transpose(1, 2)
    lfs = F.logsigmoid(fgate).transpose(1, 2)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    hs = []
    for j0 in range(0, t, l):
        qc, kc, vc = (a[:, :, j0:j0 + l] for a in (qs, ks, vs))
        ic, lfc = igs[:, :, j0:j0 + l], lfs[:, :, j0:j0 + l]
        qf, kf, vf = qc.float(), kc.float(), vc.float()
        bvec = torch.cumsum(lfc, dim=-1)                      # b_i
        g = torch.cummax(ic - bvec, dim=-1).values
        m_i = bvec + torch.maximum(m[..., None], g)           # (B,H,L)
        m_next = bvec[..., -1] + torch.maximum(m, g[..., -1])

        # inter-chunk contribution
        w0 = torch.exp(m[..., None] + bvec - m_i)
        h_inter = (qf @ c.transpose(-1, -2)) * w0[..., None]  # (B,H,L,dv)
        den_inter = (qf @ n[..., None])[..., 0] * w0

        # intra-chunk: D_ij = exp(b_i - b_j + i~_j - m_i) for j <= i
        dmat = (bvec[..., :, None] - bvec[..., None, :]
                + ic[..., None, :] - m_i[..., :, None])
        w = torch.exp(torch.where(tri, dmat, M_INIT))         # (B,H,L,L)
        scores = (qf @ kf.transpose(-1, -2)) * w
        h_intra = scores @ vf
        den_intra = scores.sum(-1)

        den = torch.maximum((den_inter + den_intra).abs(), torch.exp(-m_i))
        hs.append(((h_inter + h_intra) / den[..., None]).to(qc.dtype))

        # state update
        wc = torch.exp(m[..., None] + bvec[..., -1:] - m_next[..., None])
        wj = torch.exp(bvec[..., -1:] - bvec + ic - m_next[..., None])
        c = c * wc[..., None] + (vf * wj[..., None]).transpose(-1, -2) @ kf
        n = n * wc + (wj[..., None] * kf).sum(-2)
        m = m_next
    # (B, H, T, dh) -> (B, T, H, dh)
    return torch.cat(hs, dim=2).transpose(1, 2), (c, n, m)


def _keep_or_step(cache, new: dict, step_active) -> None:
    """Write a block's new state into its cache in place; a decode step
    with ``step_active`` off writes the old values back."""
    for name, val in new.items():
        if step_active is not None:
            val = torch.where(step_active, val, cache[name])
        cache[name].copy_(val)


def apply_mlstm_block(p, x, cfg: ArchConfig, cache=None, step_active=None):
    """x: (B, T, d).  cache: None (prefill from zero) or ``{"conv", "c",
    "n", "m"}``, updated in place (a decode step when T == 1, else a
    prefill that captures the state).  -> out (B, T, d)."""
    dt = x.dtype
    b, t, d = x.shape
    du = 2 * d
    nh = cfg.n_xlstm_heads
    dh = du // nh

    up = x @ p["w_up"].to(dt)
    main, side = up.chunk(2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = causal_conv1d(main, p["conv"], conv_state)
    long_seq = t >= 2 * MLSTM_CHUNK
    xc = F.silu(conv_out.float())
    if long_seq:
        xc = xc.to(dt)      # compute-dtype stream; fp32 accumulation

    def qkv_proj(inp, w):
        wf = w.to(inp.dtype)
        if wf.dim() == 3:       # headwise block-diagonal projection
            nb, bs, _ = wf.shape
            return torch.einsum("btnj,njk->btnk",
                                inp.reshape(b, t, nb, bs), wf
                                ).reshape(b, t, du)
        return inp @ wf

    vin = main if long_seq else main.float()
    q = qkv_proj(xc, p["wq"]).reshape(b, t, nh, dh)
    k = qkv_proj(xc, p["wk"]).reshape(b, t, nh, dh) * dh ** -0.5
    v = qkv_proj(vin, p["wv"]).reshape(b, t, nh, dh)
    ig = ((xc @ p["w_igate"].to(xc.dtype)).float()
          + p["b_igate"].float())
    fg = ((xc @ p["w_fgate"].to(xc.dtype)).float()
          + p["b_fgate"].float())

    use_chunkwise = long_seq and t % MLSTM_CHUNK == 0
    core = _mlstm_chunkwise if use_chunkwise else _mlstm_scan
    if cache is None:
        h, _ = core(q, k, v, ig, fg)
    else:
        h, (c, n, m) = core(q, k, v, ig, fg, c0=cache["c"], n0=cache["n"],
                            m0=cache["m"])
        _keep_or_step(cache, {"conv": new_conv, "c": c, "n": n, "m": m},
                      step_active if t == 1 else None)

    h = h.reshape(b, t, du).to(dt)
    h = rms_group_norm(h, p["gn_scale"], nh)
    h = h + p["skip"].to(dt) * conv_out
    return (h * F.silu(side.float()).to(dt)) @ p["w_down"].to(dt)


def init_mlstm_cache(cfg: ArchConfig, batch: int, lead=(), device=None):
    """Zeroed state (``m`` at -1e30): ``conv`` in the compute dtype, the
    cell in fp32.  ``lead`` prepends stacking dims (the body's layers
    axis)."""
    du = 2 * cfg.d_model
    nh = cfg.n_xlstm_heads
    dh = du // nh
    lead = tuple(lead)
    f32 = torch.float32
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, du),
                            dtype=compute_dtype(cfg), device=device),
        "c": torch.zeros(lead + (batch, nh, dh, dh), dtype=f32,
                         device=device),
        "n": torch.zeros(lead + (batch, nh, dh), dtype=f32, device=device),
        "m": torch.full(lead + (batch, nh), M_INIT, dtype=f32,
                        device=device),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_specs(cfg: ArchConfig):
    d = cfg.d_model
    nh = cfg.n_xlstm_heads
    dh = d // nh
    gates = {}
    for g in ("z", "i", "f", "o"):
        gates[f"w_{g}"] = ParamSpec((d, d), ("embed", "lru"), keep_fp32=True)
        gates[f"r_{g}"] = ParamSpec((nh, dh, dh),
                                    ("heads_x", "head_rec", "head_rec_in"),
                                    init="normal", scale=0.02,
                                    keep_fp32=True)
        gates[f"b_{g}"] = ParamSpec((d,), ("lru",),
                                    init="ones" if g == "f" else "zeros",
                                    keep_fp32=True)
    gates["gn_scale"] = ParamSpec((d,), ("lru",), init="ones", keep_fp32=True)
    gates["w_out"] = ParamSpec((d, d), ("lru", "embed"))
    return gates


def _slstm_scan(p, x, state):
    """x: (B, T, d) fp32.  state: (c, n, h, m), (B, d) fp32 each but m
    (B, H).  -> hs (B, T, d) fp32 and the final state.  The loop keeps
    c, n and h as (B, H, dh) and the four gates side by side, so that a
    position dispatches few ops (a meta run counts every one)."""
    b, t, d = x.shape
    nh = p["r_z"].shape[0]
    dh = d // nh
    gates = ("z", "i", "f", "o")
    # every position's input pre-activations, (B, T, 4, H, dh)
    pre = torch.stack([x @ p[f"w_{g}"].float() + p[f"b_{g}"].float()
                       for g in gates], dim=2).reshape(b, t, 4, nh, dh)
    # the four gates' recurrent weights side by side, (H, dh, 4 dh): one
    # product a position for all four
    r_all = torch.cat([p[f"r_{g}"].float() for g in gates], dim=-1)
    c, n, h = (v.reshape(b, nh, dh) for v in state[:3])
    m = state[3]
    hs = []
    for s in range(t):
        # (H, B, dh) @ (H, dh, 4 dh) -> (B, 4, H, dh)
        rec = torch.bmm(h.transpose(0, 1), r_all).view(nh, b, 4, dh)
        g = pre[:, s] + rec.permute(1, 2, 0, 3)
        zt = torch.tanh(g[:, 0])
        it_h = g[:, 1]
        lf_h = F.logsigmoid(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        # stabiliser per head (max over the head's channels)
        m_new = torch.maximum(lf_h.max(-1).values + m, it_h.max(-1).values)
        i_p = torch.exp(it_h - m_new[..., None])
        f_p = torch.exp(lf_h + (m - m_new)[..., None])
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, t, d), (
        c.reshape(b, d), n.reshape(b, d), h.reshape(b, d), m)


def apply_slstm_block(p, x, cfg: ArchConfig, cache=None, step_active=None):
    """x: (B, T, d).  cache: None or ``{"c", "n", "h", "m"}``, updated in
    place as :func:`apply_mlstm_block`'s.  -> out (B, T, d)."""
    dt = x.dtype
    b, t, d = x.shape
    nh = cfg.n_xlstm_heads
    if cache is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, d), **f32), torch.zeros((b, d), **f32),
                 torch.zeros((b, d), **f32),
                 torch.full((b, nh), M_INIT, **f32))
        hs, _ = _slstm_scan(p, x.float(), state)
    else:
        state = tuple(cache[name] for name in ("c", "n", "h", "m"))
        hs, new = _slstm_scan(p, x.float(), state)
        _keep_or_step(cache, dict(zip(("c", "n", "h", "m"), new)),
                      step_active if t == 1 else None)
    hs = rms_group_norm(hs.to(dt), p["gn_scale"], nh)
    return hs @ p["w_out"].to(dt)


def init_slstm_cache(cfg: ArchConfig, batch: int, lead=(), device=None):
    d = cfg.d_model
    nh = cfg.n_xlstm_heads
    lead = tuple(lead)
    z = lambda *s: torch.zeros(lead + s, dtype=torch.float32, device=device)
    return {"c": z(batch, d), "n": z(batch, d), "h": z(batch, d),
            "m": torch.full(lead + (batch, nh), M_INIT, dtype=torch.float32,
                            device=device)}
