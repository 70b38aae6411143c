"""Model: config -> params / loss_fn / prefill / decode_step /
decode_horizon.

``repro.models.model`` in eager PyTorch on an explicit device: decoders
of attention, RG-LRU, xLSTM and MoE blocks, an encoder-decoder (a
bidirectional encoder over the caller's frame embeddings, a decoder with
cross-attention) and embeddings input (the caller's embeddings instead of
a token table, M-RoPE positions given or derived).  Parameters are the same
tree as the reference's (``param_specs``).  Serving's
``prepare_params`` places them on the device in the compute dtype once,
where the reference cast every weight on every call (the values are
identical), except the leaves whose specs say ``keep_fp32`` (the RG-LRU
gates and the xLSTM cells' weights, which the reference reads in fp32),
which stay fp32.  Training differentiates the fp32 leaves themselves:
``loss_fn`` casts them inside the graph, per use (each ``.to(dtype)`` of
the layers) or once up front (``cast_params_once``).

Caches are dicts of tensors updated in place (see ``transformer``); the
``idx`` entry is replaced by a new tensor on every call, as in the
reference.

Batches: ``{"tokens", "labels"}`` for token models, ``{"embeds": (B, S,
d), "labels", "positions": (B, S, 3) optional}`` for embeddings input,
``{"enc_embeds": (B, Se, d), "tokens", "labels"}`` for an
encoder-decoder.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as P
from repro_torch.models.attention import kernel_route, select_attention
from repro_torch.models.layers import (apply_norm, compute_dtype,
                                       embed_specs, embed_tokens,
                                       head_matrix, no_sharding, norm_specs)
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.models.transformer import (ATTN_KINDS, BlockCtx,
                                            apply_stack, fit_cross_cache,
                                            init_stack_cache, make_plan,
                                            stack_specs_tree)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises RuntimeError when CUDA is asked
    for and absent: the port never carries on on the CPU unasked.  The
    meta device (shapes with no storage: the dry run, the roofline) is
    taken only when the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card unless the "
            "caller passes device='cpu'")
    return device


class Model:
    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = make_plan(cfg, cross=cfg.is_encdec)
        self.enc_plan = (make_plan(cfg, n_layers=cfg.n_enc_layers)
                         if cfg.is_encdec else None)
        self.dtype = compute_dtype(cfg)

    # ----- parameters ----------------------------------------------------
    def param_specs(self):
        cfg = self.cfg
        specs = {"decoder": stack_specs_tree(cfg, self.plan),
                 "final_norm": norm_specs(cfg),
                 "embed": embed_specs(cfg)}
        if (cfg.input_mode != "tokens" and not cfg.is_encdec
                and not cfg.tie_embeddings):
            # the inputs are the caller's embeddings: only the LM head
            specs["embed"] = {"head": specs["embed"]["head"]}
        if cfg.is_encdec:
            specs["encoder"] = stack_specs_tree(cfg, self.enc_plan)
            specs["enc_final_norm"] = norm_specs(cfg)
        return specs

    def init(self, generator: torch.Generator):
        """Fresh weights drawn from ``generator`` (the reference's init
        distributions, torch's random stream), fp32 on this device."""
        return P.materialize(self.param_specs(), generator, self.device)

    def abstract_params(self):
        """Every parameter as a meta tensor of its spec's shape and
        dtype (fp32): the tree ``init`` would draw, with no storage."""
        return P.abstract(self.param_specs())

    def param_axes(self):
        """Every parameter's logical axis names (the sharding rules'
        keys), in the parameter tree's layout."""
        return P.axes_tree(self.param_specs())

    def n_params(self) -> int:
        return P.n_params(self.param_specs())

    def prepare_params(self, params):
        """One copy of every weight on this device: the compute dtype,
        except the leaves whose specs say ``keep_fp32``, kept in fp32."""
        return P.tree_map(
            lambda spec, leaf: leaf.to(
                self.device,
                torch.float32 if spec.keep_fp32 else self.dtype),
            self.param_specs(), P.is_spec, params)

    @property
    def window_cache(self) -> bool:
        """Sliding-window layers keep rolling caches (the reference's
        rule: a window and a sub-quadratic stack)."""
        return self.cfg.attn_window > 0 and self.cfg.sub_quadratic

    # ----- forward -------------------------------------------------------
    def _positions(self, b, s, offset=0):
        pos = offset + torch.arange(s, dtype=torch.int32,
                                    device=self.device)[None, :]
        pos = pos.expand(b, s)
        if self.cfg.pos == "mrope":
            return pos[..., None].expand(b, s, 3)
        return pos

    def _inputs(self, params, batch):
        """-> (x (B, S, d) in the compute dtype, positions): the token
        embeddings, or the caller's ``embeds``; ``positions`` from the
        batch when it has them."""
        cfg = self.cfg
        if cfg.is_encdec or cfg.input_mode == "tokens":
            x = embed_tokens(params["embed"], batch["tokens"], cfg)
        else:
            x = batch["embeds"].to(self.dtype)
        pos = batch.get("positions")
        if pos is None:
            pos = self._positions(*x.shape[:2])
        return x, pos

    def _encode(self, params, batch, on_card: bool, remat: bool):
        """The encoder over ``batch["enc_embeds"]``: bidirectional, at
        positions 0..Se-1, with no cache (the reference's mode "train"),
        then ``enc_final_norm``.  The caller decides what mode "train"
        would: ``on_card`` runs the flash kernel (a prefill on the card),
        otherwise the reference's attention; ``remat`` checkpoints the
        stack (the reference does in training whatever ``loss_fn`` was
        given)."""
        cfg = self.cfg
        enc_x = batch["enc_embeds"].to(self.dtype)
        b, se = enc_x.shape[:2]
        ctx = BlockCtx(cfg=cfg, mode="train",
                       positions=self._positions(b, se),
                       attn_fn=select_attention(cfg, se, on_card=on_card),
                       causal=False)
        h, _ = apply_stack(params["encoder"], enc_x, cfg, self.enc_plan, ctx,
                           remat=remat)
        return apply_norm(params["enc_final_norm"], h, cfg.norm)

    def forward(self, params, batch, *, mode="prefill", cache=None,
                shard_fn=no_sharding, remat=False, skip_future=False,
                use_ragged_kernel=False, decode_write_mask=None,
                step_active=None):
        """-> (hidden (B,S,d), new_cache, aux_loss fp32 0-d).  A decode step
        needs ``step_active`` (0-d bool tensor): off, the step advances no
        ``idx`` and leaves the recurrent state alone.  ``mode="train"``
        runs the reference's attention choice on every device (the flash
        kernel is forward only) and, with ``remat``, checkpoints the stack
        as the reference does.  An enc-dec model runs its encoder unless
        decoding; its prefill gives the cross caches the encoder's
        length.  ``shard_fn(tensor, *logical_axes)`` is called on the
        decoder's residual stream and the MoE dispatch buffers
        (``launch.sharding.make_shard_fn``; the identity by default); the
        encoder runs without it, as the reference's does."""
        cfg = self.cfg
        x, pos = self._inputs(params, batch)
        b, s = x.shape[:2]
        on_card = kernel_route(x.device) and mode != "train"
        cache = cache or {}
        enc_out = None
        if cfg.is_encdec and mode != "decode":
            enc_out = self._encode(params, batch, on_card,
                                   remat=mode == "train")
            if cache:
                fit_cross_cache(cache["stack"], enc_out.shape[1])
        ctx = BlockCtx(
            cfg=cfg, mode=mode, positions=pos,
            attn_fn=select_attention(
                cfg, s, skip_future=skip_future and mode == "prefill",
                on_card=on_card),
            enc_out=enc_out,
            shard_fn=shard_fn,
            decode_idx=cache.get("idx"),
            window_cache=self.window_cache,
            ragged_kernel=use_ragged_kernel and mode == "decode",
            decode_write_mask=(decode_write_mask if mode == "decode"
                               else None),
            page_table=cache.get("pt") if mode == "decode" else None,
            step_active=step_active if mode == "decode" else None)
        h, aux = apply_stack(params["decoder"], x, cfg, self.plan, ctx,
                             cache=cache.get("stack"), remat=remat)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        new_cache = None
        if cache:
            step = (step_active.to(cache["idx"].dtype) if mode == "decode"
                    else s)
            new_cache = dict(cache, idx=cache["idx"] + step)
        return h, new_cache, aux

    # ----- training ------------------------------------------------------
    def loss_fn(self, params, batch, shard_fn=no_sharding, remat: bool = True,
                cast_params_once: bool = False):
        """-> (loss, metrics) with metrics ``nll``, ``n_tokens``, ``loss``
        and, for MoE models, ``moe_aux`` (all fp32 0-d tensors).
        ``params`` are the fp32 leaves being differentiated; the compute
        dtype is reached inside the graph.  ``cast_params_once`` casts
        every fp32 leaf of rank >= 2 to the compute dtype up front (the
        reference's option), instead of at each use."""
        cfg = self.cfg
        if cast_params_once:
            params = P.tree_map(
                lambda p: p.to(self.dtype)
                if p.dtype == torch.float32 and p.dim() >= 2 else p,
                params, torch.is_tensor)
        h, _, aux = self.forward(params, batch, mode="train",
                                 shard_fn=shard_fn, remat=remat)
        head = head_matrix(params["embed"], cfg)
        nll, n_tok = chunked_softmax_xent(h, head, batch["labels"],
                                          mask=batch.get("loss_mask"))
        loss = nll
        metrics = {"nll": nll, "n_tokens": n_tok}
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_coef * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    # ----- serving -------------------------------------------------------
    @property
    def supports_padded_prefill(self) -> bool:
        """Trailing-pad bucketed prefill is exact: every block is causal
        attention and no rolling-window cache."""
        descs = tuple(self.plan.prefix) + tuple(self.plan.period)
        return (all(d.kind in ATTN_KINDS for d in descs)
                and not self.window_cache)

    @property
    def supports_paged_cache(self) -> bool:
        """The paged KV layout is exact: every block full-context
        attention, decoder-only."""
        cfg = self.cfg
        descs = tuple(self.plan.prefix) + tuple(self.plan.period)
        return (all(d.kind in ATTN_KINDS for d in descs)
                and cfg.attn_window == 0 and not cfg.is_encdec)

    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   per_slot: bool = False, page_size: int = 0,
                   n_pages: int = 0):
        """``enc_len`` sizes an enc-dec model's cross caches (the prefill
        gives them the encoder's length whatever it was).  ``per_slot``
        makes ``idx`` a (B,) vector (continuous batching).  ``page_size >
        0`` builds the paged cache with a sentinel-filled page table
        ``pt`` of shape ``(B, max_len // page_size)``."""
        if page_size > 0:
            if not self.supports_paged_cache:
                raise ValueError(f"{self.cfg.name}: arch does not support "
                                 f"the paged KV cache")
            if max_len % page_size or n_pages <= 0:
                raise ValueError(f"paged cache needs page_size | max_len "
                                 f"and n_pages > 0 ({max_len}, "
                                 f"{page_size}, {n_pages})")
        stack = init_stack_cache(self.cfg, self.plan, batch_size, max_len,
                                 enc_len=enc_len,
                                 window_cache=self.window_cache,
                                 page_size=page_size, n_pages=n_pages,
                                 device=self.device)
        idx = torch.zeros((batch_size,) if per_slot else (),
                          dtype=torch.int32, device=self.device)
        cache = {"stack": stack, "idx": idx}
        if page_size > 0:
            cache["pt"] = torch.full((batch_size, max_len // page_size),
                                     n_pages, dtype=torch.int32,
                                     device=self.device)
        return cache

    def _logits(self, params, h):
        head = head_matrix(params["embed"], self.cfg)
        return (h @ head.to(h.dtype)).float()

    def prefill(self, params, batch, cache, shard_fn=no_sharding,
                skip_future: bool = True, last_index=None):
        """Run the prompt, fill the cache; -> (last_logits, cache).
        ``last_index`` ((B,) int) gathers each row's logits at its own
        last real token (bucketed prefill pads prompts at the end)."""
        h, new_cache, _ = self.forward(params, batch, mode="prefill",
                                       cache=cache, shard_fn=shard_fn,
                                       skip_future=skip_future)
        if last_index is None:
            last = h[:, -1, :]
        else:
            rows = torch.arange(h.shape[0], device=h.device)
            last = h[rows, last_index.long()]
        return self._logits(params, last), new_cache

    def decode_step(self, params, cache, tokens=None, embeds=None,
                    shard_fn=no_sharding, use_ragged_kernel=False,
                    write_mask=None, step_active=None):
        """One decode step.  tokens: (B,) int, or embeds: (B, d) for
        embeddings input (M-RoPE positions: ``idx`` on all three
        streams).  -> (logits (B,V) fp32, new_cache).  An enc-dec decoder
        attends over its cross caches.  With a per-slot cache each row
        decodes at its own position.  ``write_mask`` ((B,) bool) gates the
        cache writes per row; ``step_active`` (0-d bool tensor, default
        on) off makes the step leave ``idx`` and the recurrent state as
        they were.  On a CUDA device attention runs the CUDA kernels
        whatever ``use_ragged_kernel`` says; on the CPU it picks the
        kernels' plain versions (True) or ``attention_decode`` (False)."""
        cfg = self.cfg
        idx = cache["idx"]
        if tokens is not None:
            batch = {"tokens": tokens[:, None]}
            b = tokens.shape[0]
        else:
            batch = {"embeds": embeds[:, None, :]}
            b = embeds.shape[0]
        if idx.dim() == 1:
            pos = idx[:, None].int()
        else:
            pos = idx.reshape(1, 1).expand(b, 1).int()
        if cfg.pos == "mrope":
            pos = pos[..., None].expand(b, 1, 3)
        if step_active is None:
            step_active = torch.ones((), dtype=torch.bool,
                                     device=self.device)
        batch["positions"] = pos
        h, new_cache, _ = self.forward(
            params, batch, mode="decode", cache=cache, shard_fn=shard_fn,
            use_ragged_kernel=use_ragged_kernel,
            decode_write_mask=write_mask, step_active=step_active)
        return self._logits(params, h[:, 0, :]), new_cache

    def decode_horizon(self, params, cache, state, *, horizon: int,
                       max_len: int, use_ragged_kernel=False,
                       n_steps: Optional[int] = None):
        """Up to ``horizon`` fused greedy decode steps with no host sync.

        ``state`` (all (B,)): ``tok`` next token to feed, ``remaining``
        budget, ``finished``, ``eos`` / ``has_eos``.  -> (cache, state,
        trace), every trace leaf (horizon, B): ``tok`` emitted, ``live``,
        ``bonus_tok`` / ``bonus`` (cache-edge lookahead token),
        ``retired``.

        The reference's ``while_loop`` stops once every slot has finished.
        Checking that on the host would cost one sync per token, so each
        step here computes an on-device "any live" flag instead: a step
        taken after the last slot finished writes nothing (every row's
        write mask is off), leaves ``idx`` and the state as they were, and
        leaves its trace row all-dead, exactly like a step the reference
        never ran.  ``n_steps`` (<= horizon) lets the caller stop earlier
        when it knows the budgets run out; rows past it stay all-dead.
        Token decoder-only models only, as in the reference."""
        if self.cfg.input_mode != "tokens" or self.cfg.is_encdec:
            raise ValueError("the fused horizon decodes token models")
        eos, has_eos = state["eos"], state["has_eos"]
        tok, remaining = state["tok"], state["remaining"]
        finished = state["finished"]
        b = tok.shape[0]
        dev = tok.device
        trace = {name: torch.zeros((horizon, b), dtype=dt, device=dev)
                 for name, dt in (("tok", torch.int32), ("live", torch.bool),
                                  ("bonus_tok", torch.int32),
                                  ("bonus", torch.bool),
                                  ("retired", torch.bool))}
        steps = horizon if n_steps is None else min(horizon, n_steps)
        for s in range(steps):
            active = ~finished.all()
            live = ~finished
            logits, cache = self.decode_step(
                params, cache, tokens=tok, write_mask=live,
                use_ragged_kernel=use_ragged_kernel,
                step_active=active)
            nxt = logits.argmax(-1).to(torch.int32)
            rem = torch.where(live, remaining - 1, remaining)
            fin_new = live & ((rem <= 0) | (has_eos & (nxt == eos)))
            # a live slot that would overrun the cache emits its
            # lookahead token and retires
            bonus = live & ~fin_new & (cache["idx"] >= max_len - 1)
            finished = finished | fin_new | bonus
            out = {"tok": tok, "live": live, "bonus_tok": nxt,
                   "bonus": bonus, "retired": live & finished}
            for name, val in out.items():
                trace[name][s] = torch.where(active, val,
                                             torch.zeros_like(val))
            tok = torch.where(live, nxt, tok)
            remaining = rem
        new_state = dict(state, tok=tok, remaining=remaining,
                         finished=finished)
        return cache, new_state, trace
