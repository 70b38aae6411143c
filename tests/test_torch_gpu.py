"""The port's CUDA kernels (decode and prefill attention, RG-LRU scan)
on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
built with nvcc at first use and have no CPU mode): the ``cuda`` fixture
skips them where there is no card.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 5e-5 (the same arithmetic as the plain version, summed
in another order); bf16 4 * 2^-8 * max|plain output|, between 2 and 4
bf16 ulps of the largest output (both accumulate in fp32 and round once
to bf16, so they differ by about one ulp; the prefill kernel's
tensor-core P V also rounds P to bf16, which ``test_torch_flash.py``
emulates on the CPU within the same limit).  The RG-LRU scan runs the
plain version's own operations, its carry into each chunk reassociated
(``test_torch_rglru_chunked.py`` emulates the chunks on the CPU), so it
is held to 1e-5 * max(1, max|plain output|) in fp32 and the same bf16
limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import ref as rglru_ref
from repro_torch.models import Model
from test_torch_isolation import EXAMPLES, load_example

pytestmark = pytest.mark.gpu

FP32_TOL = 5e-5
BF16_REL_TOL = 4 * 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_within_tolerance(out, expect, fp32_tol=FP32_TOL):
    tol = (BF16_REL_TOL * expect.float().abs().max().item()
           if expect.dtype == torch.bfloat16 else fp32_tol)
    assert (out.float() - expect.float()).abs().max().item() <= tol


def _assert_rows_within_tolerance(out, expect):
    """bf16 attention, row by row: each (query, head) row's error within
    BF16_REL_TOL of its own max |plain|, so that rows averaging over many
    keys, far smaller than the first causal rows, are held too."""
    if expect.dtype == torch.bfloat16:
        err = (out.float() - expect.float()).abs().amax(-1)
        assert (err <= BF16_REL_TOL * expect.float().abs().amax(-1)).all()


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,dh", [(2, 16), (3, 20), (7, 64), (1, 128),
                                  (2, 256), (8, 128)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ragged_kernel_matches_plain(cuda, g, dh, dtype, softcap):
    gen = torch.Generator(device="cuda").manual_seed(g * dh)
    b, hkv, smax = 5, 2, 96
    cur = torch.tensor([0, 1, 95, 96, 400], dtype=torch.int32, device=cuda)
    q = _rand(gen, (b, 1, hkv * g, dh), dtype)
    k = _rand(gen, (b, smax, hkv, dh), dtype)
    v = _rand(gen, (b, smax, hkv, dh), dtype)
    out = ops.flash_decode_attention(q, k, v, cur, softcap=softcap)
    torch.cuda.synchronize()
    expect = ref.ragged_decode_ref(q, k, v, cur, softcap=softcap)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_within_tolerance(out, expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,dh,ps", [(2, 16, 8), (3, 20, 16), (7, 64, 64),
                                     (8, 128, 64)])
def test_paged_kernel_matches_plain(cuda, g, dh, ps, dtype):
    """A tight pool, scrambled disjoint tables, sentinel entries, and a
    retired row whose table is all sentinel."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, hkv, max_pages = 4, 2, 6
    max_len = max_pages * ps
    cur_list = [0, max_len - 1, ps, max_len + 5]
    n_pages = 1 + max_pages + 2 + 1
    perm = torch.randperm(n_pages, generator=gen, device=cuda).int()
    pt = torch.full((b, max_pages), n_pages, dtype=torch.int32, device=cuda)
    pt[0, :1], pt[1, :], pt[2, :2] = perm[:1], perm[1:7], perm[7:9]
    cur = torch.tensor(cur_list, dtype=torch.int32, device=cuda)
    q = _rand(gen, (b, 1, hkv * g, dh), dtype)
    kp = _rand(gen, (n_pages, ps, hkv, dh), dtype)
    vp = _rand(gen, (n_pages, ps, hkv, dh), dtype)
    out = ops.paged_flash_decode_attention(q, kp, vp, pt, cur)
    torch.cuda.synchronize()
    expect = ref.paged_decode_ref(q, kp, vp, pt, cur)
    _assert_within_tolerance(out, expect)


def _scatter_pages(gen, k, v, ps):
    """The contiguous cache (B, Smax, Hkv, dh) scattered over scrambled
    pages: -> (k pages, v pages, page table)."""
    b, smax, hkv, dh = k.shape
    n = b * smax // ps
    perm = torch.randperm(n, generator=gen, device="cuda")
    kp, vp = torch.empty_like(k).view(n, ps, hkv, dh), \
        torch.empty_like(v).view(n, ps, hkv, dh)
    kp[perm], vp[perm] = k.reshape(n, ps, hkv, dh), v.reshape(n, ps, hkv, dh)
    return kp, vp, perm.reshape(b, smax // ps).int()


def test_paged_equals_contiguous_bit_for_bit(cuda):
    """Both kernels cut keys into the same chunks and walk them in the
    same order: the same cache through either gives identical outputs, at
    a short cache and at qwen2-0.5b's long one (Smax 4096: 32 splits a
    row) over pages of 16 and 64."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, hkv, g, dh = 3, 2, 7, 64
    chunk = ops.decode_splits(1)[0]
    for smax, ps, lengths in ((256, 32, [5, 200, 255]),
                              (4096, 16, [chunk, 3000, 4095]),
                              (4096, 64, [chunk - 1, 2049, 4096])):
        cur = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        q = _rand(gen, (b, 1, hkv * g, dh), torch.bfloat16)
        k = _rand(gen, (b, smax, hkv, dh), torch.bfloat16)
        v = _rand(gen, (b, smax, hkv, dh), torch.bfloat16)
        kp, vp, table = _scatter_pages(gen, k, v, ps)
        assert torch.equal(ops.flash_decode_attention(q, k, v, cur),
                           ops.paged_flash_decode_attention(q, kp, vp, table,
                                                            cur)), (smax, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cross_attention_decode_shape_matches_plain(cuda, dtype):
    """seamless-m4t-large-v2's cross-attention decode: every row attends
    over the whole encoder cache (cur = Se - 1) at 16 KV heads, G 1,
    dh 64, 4096 frames."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    b, hkv, dh, se = 2, 16, 64, 4096
    cur = torch.full((b,), se - 1, dtype=torch.int32, device=cuda)
    q = _rand(gen, (b, 1, hkv, dh), dtype)
    k = _rand(gen, (b, se, hkv, dh), dtype)
    v = _rand(gen, (b, se, hkv, dh), dtype)
    out = ops.flash_decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    expect = ref.ragged_decode_ref(q, k, v, cur)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_kernels_match_plain_at_long_caches(cuda, dtype, softcap):
    """qwen2-0.5b's long caches (Smax 4096, G 7, dh 64): rows spanning
    many splits, ending on both sides of chunk edges, a retired row;
    bf16 held per case and per row."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, hkv, g, dh, smax, ps = 8, 2, 7, 64, 4096, 64
    chunk = ops.decode_splits(smax)[0]
    cur = torch.tensor([chunk - 1, chunk, chunk + 1, 1039, 2047, 3000,
                        4016, 5000], dtype=torch.int32, device=cuda)
    q = _rand(gen, (b, 1, hkv * g, dh), dtype)
    k = _rand(gen, (b, smax, hkv, dh), dtype)
    v = _rand(gen, (b, smax, hkv, dh), dtype)
    out = ops.flash_decode_attention(q, k, v, cur, softcap=softcap)
    torch.cuda.synchronize()
    expect = ref.ragged_decode_ref(q, k, v, cur, softcap=softcap)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)
    kp, vp, table = _scatter_pages(gen, k, v, ps)
    out = ops.paged_flash_decode_attention(q, kp, vp, table, cur,
                                           softcap=softcap)
    torch.cuda.synchronize()
    expect = ref.paged_decode_ref(q, kp, vp, table, cur, softcap=softcap)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernels_read_unaligned_views(cuda, dtype):
    """K/V as views one element into a wider buffer (not 16-byte aligned)
    and q in bf16 with dh 64: the wrappers take the element loads, and
    the result is the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, hkv, g, dh, smax, ps = 4, 2, 7, 64, 512, 16
    cur = torch.tensor([5, 127, 128, 511], dtype=torch.int32, device=cuda)
    q = _rand(gen, (b, 1, hkv * g, dh), dtype)
    flat = _rand(gen, (2, b * smax * hkv * dh + 1), dtype)
    k = flat[0, 1:].view(b, smax, hkv, dh)
    v = flat[1, 1:].view(b, smax, hkv, dh)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    out = ops.flash_decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    expect = ref.ragged_decode_ref(q, k, v, cur)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)
    n = b * smax // ps
    table = torch.randperm(n, generator=gen, device=cuda).reshape(
        b, smax // ps).int()
    kp, vp = k.reshape(n, ps, hkv, dh), v.reshape(n, ps, hkv, dh)
    out = ops.paged_flash_decode_attention(q, kp, vp, table, cur)
    torch.cuda.synchronize()
    expect = ref.paged_decode_ref(q, kp, vp, table, cur)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)


def _capture(fn):
    """``fn()`` warmed up on a side stream, then captured in a CUDA
    graph; -> (the graph, what the captured call returned: the buffers
    each replay writes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                        # warm up off capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def test_decode_wrappers_replay_in_a_cuda_graph(cuda):
    """One call of each decode wrapper captured in a CUDA graph: with cur
    changed in place, a replay gives the eager result bit for bit, so the
    launch (grid, split count, workspace) does not depend on cur."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    b, hkv, g, dh, smax, ps = 4, 2, 7, 64, 1024, 16
    q = _rand(gen, (b, 1, hkv * g, dh), torch.bfloat16)
    k = _rand(gen, (b, smax, hkv, dh), torch.bfloat16)
    v = _rand(gen, (b, smax, hkv, dh), torch.bfloat16)
    kp, vp, table = _scatter_pages(gen, k, v, ps)
    cur = torch.tensor([3, 100, 500, 1000], dtype=torch.int32, device=cuda)
    calls = {
        "ragged": lambda: ops.flash_decode_attention(q, k, v, cur),
        "paged": lambda: ops.paged_flash_decode_attention(q, kp, vp, table,
                                                          cur),
    }
    for name, call in calls.items():
        cur.copy_(torch.tensor([3, 100, 500, 1000]))
        graph, out = _capture(call)
        for lengths in ([1023, 0, 128, 5000], [127, 129, 700, 1]):
            cur.copy_(torch.tensor(lengths))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, call()), (name, lengths)


def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = _rand(gen, (2, 1, 4, 16), torch.float32)
    k = _rand(gen, (2, 32, 2, 16), torch.float32)
    cur = torch.tensor([3, 31], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    ops.flash_decode_attention(q, k, k, cur)
    assert ops.LAUNCHES == {"ragged_decode": 1, "paged_decode": 0,
                            "flash_attention": 0}
    with pytest.raises(ValueError):
        ops.flash_decode_attention(q, k, k, cur.long())
    with pytest.raises(ValueError):
        ops.flash_decode_attention(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, k, cur)
    with pytest.raises(TypeError):
        ops.flash_decode_attention(q.half(), k.half(), k.half(), cur)
    assert ops.LAUNCHES["ragged_decode"] == 1


def test_shape_counter_keys_each_launch(cuda):
    """One launch gives one (kernel, dtype, shape) key with count 1; a
    second launch at the same signature counts 2; a refused call and a
    CPU call add nothing; the reset clears the keys."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = _rand(gen, (2, 1, 4, 16), torch.float32)
    k = _rand(gen, (2, 32, 2, 16), torch.float32)
    cur = torch.tensor([3, 31], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    ops.flash_decode_attention(q, k, k, cur)
    ragged = ("ragged_decode", "float32", (2, 32, 2, 2, 16, 0, 0.0))
    assert ops.SHAPE_LAUNCHES == {ragged: 1}
    with pytest.raises(ValueError):
        ops.flash_decode_attention(q, k, k, cur.long())
    ops.flash_decode_attention(q.cpu(), k.cpu(), k.cpu(), cur.cpu())
    ops.flash_decode_attention(q, k, k, cur)
    assert ops.SHAPE_LAUNCHES == {ragged: 2}
    pages, table = k.reshape(8, 8, 2, 16), torch.arange(
        8, dtype=torch.int32, device=cuda).reshape(2, 4)
    ops.paged_flash_decode_attention(q.bfloat16(), pages.bfloat16(),
                                     pages.bfloat16(), table, cur,
                                     softcap=30.0)
    qs = _rand(gen, (2, 9, 4, 16), torch.float32)
    ops.flash_attention(qs, k, k, causal=False)
    assert ops.SHAPE_LAUNCHES == {
        ragged: 2,
        ("paged_decode", "bfloat16", (2, 32, 2, 2, 16, 8, 30.0)): 1,
        ("flash_attention", "float32",
         (2, 9, 32, 4, 2, 16, False, 0, 0.0)): 1}
    assert ops.LAUNCHES == {"ragged_decode": 2, "paged_decode": 1,
                            "flash_attention": 1}
    ops.reset_launch_counts()
    assert ops.SHAPE_LAUNCHES == {}


@pytest.mark.parametrize("pages", [False, True])
def test_model_decode_runs_the_kernels(cuda, pages):
    """On the card decode attention launches the kernel in every layer,
    whatever use_ragged_kernel says, and the logits match the CPU's."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    kv = np.random.default_rng(0).standard_normal((2, 2, 2, 32, 2, 16))
    logits = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, dev)
        p = m.prepare_params(params)
        paged = dict(page_size=8, n_pages=8) if pages else {}
        cache = m.init_cache(2, 32, per_slot=True, **paged)
        layers = cache["stack"]["body"][0]["attn"]
        for name, val in zip(("k", "v"), torch.as_tensor(kv).float()):
            layers[name].view(val.shape).copy_(val)
        if pages:
            cache["pt"][:] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
        cache["idx"][:] = torch.tensor([0, 21], dtype=torch.int32)
        ops.reset_launch_counts()
        out, _ = m.decode_step(p, cache, torch.tensor([3, 4], device=dev),
                               use_ragged_kernel=False)
        logits[dev] = out.cpu()
        name = "paged_decode" if pages else "ragged_decode"
        assert ops.LAUNCHES[name] == (cfg.n_layers if dev == "cuda" else 0)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0,
                               atol=1e-4)


def _requests():
    """Eleven requests for a 48-token cache: ragged prompts and budgets,
    one EOS id, and one prompt that reaches the cache edge."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(5)
    out = []
    for rid in range(10):
        prompt = rng.integers(1, 128, size=int(rng.integers(2, 20)))
        out.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(1, 9)),
                           eos_id=7 if rid == 4 else None))
    out.append(Request(rid=10, prompt=np.arange(1, 41, dtype=np.int32),
                       max_new_tokens=20))
    return out


def _submit_requests(eng):
    for req in _requests():
        eng.submit(req)


def _engine_run(cfg, params, device, horizon, pages, buckets="auto"):
    from repro_torch.core.plan import EndpointPlan, SharingVector
    from repro_torch.serve.engine import ContinuousEngine
    plan = EndpointPlan(
        vector=SharingVector(pages=4 if pages else 1), n_slots=3,
        max_len=48, decode_horizon=horizon, prefill_buckets=buckets,
        executor="continuous", page_budget=8 if pages else None)
    eng = ContinuousEngine(cfg, params, plan, device=device)
    _submit_requests(eng)
    done = {r.rid: r.output for r in eng.run()}
    return done, eng.admit_order, eng.retire_steps


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
def test_engine_on_card_matches_cpu(cuda, pages):
    """The per-step loop (K=1), the fused horizon (K=4) and exact-length
    admission on the card serve the CPU's tokens, admission order and
    retirement steps at fp32 (tight shared page pool when paged)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for horizon, buckets in ((1, "auto"), (4, "auto"), (4, None)):
        expect = _engine_run(cfg, params, "cpu", horizon, pages, buckets)
        got = _engine_run(cfg, params, "cuda", horizon, pages, buckets)
        assert got == expect, (horizon, buckets)


@pytest.mark.parametrize("arch,pages", [
    ("granite-moe-1b-a400m", False), ("granite-moe-1b-a400m", True),
    ("deepseek-moe-16b", False), ("xlstm-1.3b", False)],
    ids=["granite-contiguous", "granite-pages4", "deepseek-contiguous",
         "xlstm"])
def test_family_engine_on_card_matches_cpu(cuda, arch, pages):
    """The MoE and xLSTM smoke configs at fp32: the per-step loop, the
    fused horizon and (MoE) exact-length admission serve the CPU's
    tokens, admission order and retirement steps."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for horizon, buckets in ((1, "auto"), (4, "auto"), (4, None)):
        expect = _engine_run(cfg, params, "cpu", horizon, pages, buckets)
        got = _engine_run(cfg, params, "cuda", horizon, pages, buckets)
        assert got == expect, (horizon, buckets)


@pytest.mark.parametrize("arch,s", [("granite-moe-1b-a400m", 1),
                                    ("granite-moe-1b-a400m", 64),
                                    ("deepseek-moe-16b", 1)])
def test_moe_dispatch_replays_in_a_cuda_graph(cuda, arch, s):
    """``apply_moe`` (routing, the sort-based dispatch with its capacity,
    the expert products and the ordered combine) captured in a graph:
    replays on new inputs equal the eager call bit for bit, and the eager
    call equals the CPU's at fp32."""
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import make_plan
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    assert make_plan(cfg).period[0].ffn == "moe"
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    p_cpu = tree_map(lambda a: a[0], params["decoder"]["body"][0]["moe"],
                     torch.is_tensor)
    p = tree_map(lambda a: a.cuda(), p_cpu, torch.is_tensor)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((8, s, cfg.d_model), generator=gen).cuda()
    graph, (y, y_aux) = _capture(lambda: apply_moe(p, x, cfg))
    for seed in (2, 3):
        x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed)))
        graph.replay()
        torch.cuda.synchronize()
        eager, aux = apply_moe(p, x, cfg)
        assert torch.equal(y, eager) and torch.equal(y_aux, aux)
        cpu, cpu_aux = apply_moe(p_cpu, x.cpu(), cfg)
        torch.testing.assert_close(eager.cpu(), cpu, rtol=0, atol=1e-5)
        torch.testing.assert_close(aux.cpu(), cpu_aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_step_replays_in_a_cuda_graph(cuda, kind):
    """One xLSTM decode step (T = 1) captured in a graph on a static
    cache: each replay advances the state in place as the eager step
    does, bit for bit, and a replay with ``step_active`` off leaves
    every leaf as it was."""
    from repro_torch.models import xlstm
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    pos = 0 if kind == "mlstm" else 3
    p = {k: v[0].cuda() for k, v in
         params["decoder"]["body"][pos][kind].items()}
    init = getattr(xlstm, f"init_{kind}_cache")
    apply = getattr(xlstm, f"apply_{kind}_block")
    gen = torch.Generator().manual_seed(4)
    cache = init(cfg, 3, device="cuda")
    apply(p, torch.randn((3, 9, cfg.d_model), generator=gen).cuda(), cfg,
          cache)
    twin = {k: v.clone() for k, v in cache.items()}
    x = torch.zeros((3, 1, cfg.d_model), device="cuda")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    ptrs = [v.data_ptr() for v in cache.values()]
    snapshot = {k: v.clone() for k, v in cache.items()}
    graph, y = _capture(lambda: apply(p, x, cfg, cache, step_active=active))
    for k, v in cache.items():     # warm-up and capture leave no trace
        v.copy_(snapshot[k])
    for seed in (5, 6):
        x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed)))
        graph.replay()
        eager = apply(p, x, cfg, twin, step_active=active)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        for k in cache:
            assert torch.equal(cache[k], twin[k]), k
    active.fill_(False)
    before = {k: v.clone() for k, v in cache.items()}
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert [v.data_ptr() for v in cache.values()] == ptrs


# ----- RG-LRU scan -------------------------------------------------------------

def _rglru_inputs(gen, b, t, c, a_dtype, x_dtype):
    """a near 0.999 (1 - 0.001 * U(0, 1)), so the carry grows to about
    1000 times x."""
    u = torch.rand((b, t, c), generator=gen, device="cuda")
    a = (1.0 - 1e-3 * u).to(a_dtype)
    x = _rand(gen, (b, t, c), x_dtype)
    return a, x


def _rglru_limit(expect):
    """fp32: 1e-5 * max(1, max|plain|); bf16 outputs take BF16_REL_TOL."""
    return 1e-5 * max(1.0, expect.float().abs().max().item())


@pytest.mark.parametrize("a_dtype,x_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)], ids=["f32", "bf16", "f32_bf16"])
@pytest.mark.parametrize("t", [1, 7, 16, 17, 33, 300, 1024, 1025])
@pytest.mark.parametrize("c", [64, 200])
def test_rglru_kernel_matches_plain(cuda, t, c, a_dtype, x_dtype):
    """T = 1 and 7 run one chunk (pass 2 alone); at B = 2 and these C the
    plan cuts chunks of 16 steps up to its cap of 64 chunks (T = 1024),
    then of 32 (T = 1025)."""
    gen = torch.Generator(device="cuda").manual_seed(t * c)
    a, x = _rglru_inputs(gen, 2, t, c, a_dtype, x_dtype)
    out = rglru_ops.rglru_scan(a, x)
    torch.cuda.synchronize()
    expect = rglru_ref.rglru_scan_ref(a, x)
    assert out.dtype == x_dtype and out.shape == x.shape
    _assert_within_tolerance(out, expect, _rglru_limit(expect))


@pytest.mark.parametrize("t,c,x_dtype", [
    (50, 96, torch.float32), (17, 200, torch.bfloat16),
    (1025, 200, torch.bfloat16), (3001, 200, torch.bfloat16)])
def test_rglru_kernel_reads_strided_views(cuda, t, c, x_dtype):
    """B = 3, a as a transposed view, x as every other channel of a wider
    tensor: read in place through their strides, over 2 to 63 chunks."""
    gen = torch.Generator(device="cuda").manual_seed(t)
    a, x = _rglru_inputs(gen, 3, t, c, torch.float32, x_dtype)
    a_view = a.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.stack([x, -x], dim=-1).flatten(-2)[..., ::2]
    assert not a_view.is_contiguous() and not wide.is_contiguous()
    assert rglru_ops.scan_chunks(3, t, c)[1] > 1
    out = rglru_ops.rglru_scan(a_view, wide)
    torch.cuda.synchronize()
    expect = rglru_ref.rglru_scan_ref(a, x)
    _assert_within_tolerance(out, expect, _rglru_limit(expect))


@pytest.mark.parametrize("b,t", [(1, 2048), (1, 3001), (2, 3001),
                                 (1, 3500)])
def test_rglru_kernel_matches_plain_at_recurrentgemma_width(cuda, b, t):
    """C = 2560 with a near 0.999, at the prefill lengths of the main path:
    chunks of 32 to 96 steps, each chunk's carry-in reassociated."""
    gen = torch.Generator(device="cuda").manual_seed(b * t)
    a, x = _rglru_inputs(gen, b, t, 2560, torch.float32, torch.float32)
    assert rglru_ops.scan_chunks(b, t, 2560)[1] > 1
    out = rglru_ops.rglru_scan(a, x)
    torch.cuda.synchronize()
    expect = rglru_ref.rglru_scan_ref(a, x)
    _assert_within_tolerance(out, expect, _rglru_limit(expect))


def test_rglru_kernel_is_deterministic(cuda):
    """The fold runs in chunk order with no atomics: two calls on the same
    inputs agree bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    a, x = _rglru_inputs(gen, 1, 3500, 2560, torch.float32, torch.float32)
    first = rglru_ops.rglru_scan(a, x)
    assert torch.equal(first, rglru_ops.rglru_scan(a, x))


def test_rglru_wrapper_replays_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph: new inputs copied into the same
    buffers give, on replay, the plain version's result (the plan and the
    scratch come from the shape alone)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    a, x = _rglru_inputs(gen, 1, 2048, 2560, torch.float32, torch.float32)
    graph, out = _capture(lambda: rglru_ops.rglru_scan(a, x))
    for seed in (7, 8):
        new_a, new_x = _rglru_inputs(torch.Generator(
            device="cuda").manual_seed(seed), 1, 2048, 2560, torch.float32,
            torch.float32)
        a.copy_(new_a)
        x.copy_(new_x)
        graph.replay()
        torch.cuda.synchronize()
        expect = rglru_ref.rglru_scan_ref(new_a, new_x)
        _assert_within_tolerance(out, expect, _rglru_limit(expect))
        assert torch.equal(out, rglru_ops.rglru_scan(a, x))


def test_rglru_wrapper_counts_launches_and_rejects_bad_inputs(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    a, x = _rglru_inputs(gen, 2, 5, 8, torch.float32, torch.float32)
    rglru_ops.reset_launch_counts()
    rglru_ops.rglru_scan(a, x)
    assert rglru_ops.LAUNCHES == {"rglru_scan": 1}
    a2, x2 = _rglru_inputs(gen, 1, 2048, 2560, torch.float32, torch.float32)
    rglru_ops.rglru_scan(a2, x2)        # two passes, one count
    assert rglru_ops.LAUNCHES == {"rglru_scan": 2}
    rglru_ops.reset_launch_counts()
    rglru_ops.rglru_scan(a, x)
    assert rglru_ops.LAUNCHES == {"rglru_scan": 1}
    with pytest.raises(RuntimeError):
        rglru_ops.rglru_scan(a, x.cpu())
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(a, x[:, :4])
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(a[0], x[0])
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(a[:, :0], x[:, :0])
    with pytest.raises(TypeError):
        rglru_ops.rglru_scan(a.half(), x.half())
    assert rglru_ops.LAUNCHES == {"rglru_scan": 1}


def _rgemma_fp32():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              compute_dtype="float32")
    return cfg, Model(cfg, "cpu").init(torch.Generator().manual_seed(0))


def test_recurrentgemma_prefill_runs_the_scan_kernel(cuda):
    """On the card every RG-LRU block's prefill launches the kernel once;
    the rolling-window layer takes no decode kernel; logits and caches
    match the CPU's."""
    cfg, params = _rgemma_fp32()
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(1, 128, (2, 23)), dtype=torch.int32)
    n_rglru = sum(k == "rglru" for k in cfg.pattern_for(cfg.n_layers))
    got = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, dev)
        p = m.prepare_params(params)
        cache = m.init_cache(2, 40, per_slot=True)
        rglru_ops.reset_launch_counts()
        ops.reset_launch_counts()
        logits, cache = m.prefill(p, {"tokens": toks.to(dev)}, cache)
        assert rglru_ops.LAUNCHES["rglru_scan"] == (
            n_rglru if dev == "cuda" else 0)
        step, cache = m.decode_step(p, cache, logits.argmax(-1))
        assert ops.LAUNCHES == {
            "ragged_decode": 0, "paged_decode": 0,
            "flash_attention": cfg.n_layers - n_rglru if dev == "cuda"
            else 0}
        got[dev] = (logits.cpu(), step.cpu())
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("horizon", [1, 4])
def test_recurrentgemma_engine_on_card_matches_cpu(cuda, horizon):
    """Exact-length admission, rolling cache and recurrent state on the
    card serve the CPU's tokens, admission order and retirement steps at
    fp32, with prompts past the window (16)."""
    from repro_torch.core.plan import EndpointPlan
    from repro_torch.serve.engine import ContinuousEngine, Request
    cfg, params = _rgemma_fp32()
    runs = []
    for dev in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, EndpointPlan(
            n_slots=3, max_len=48, decode_horizon=horizon,
            executor="continuous"), device=dev)
        rng = np.random.default_rng(6)
        for rid in range(8):
            prompt = rng.integers(1, 128, size=int(rng.integers(3, 40)))
            eng.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                               max_new_tokens=int(rng.integers(1, 20))))
        done = {r.rid: r.output for r in eng.run()}
        runs.append((done, eng.admit_order, eng.retire_steps))
    assert runs[0] == runs[1]


# ----- prefill (flash) attention -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window,softcap", [
    (1, 128, 128, 2, 2, 16, True, 0, 0.0),
    (2, 128, 128, 4, 2, 32, True, 0, 0.0),
    (1, 256, 256, 6, 2, 64, True, 0, 0.0),
    (2, 64, 64, 5, 1, 16, True, 0, 0.0),
    (1, 128, 128, 8, 8, 8, True, 0, 0.0),
    (1, 128, 128, 2, 1, 16, True, 16, 0.0),
    (1, 128, 128, 2, 1, 16, True, 64, 0.0),
    (1, 64, 128, 2, 2, 16, False, 0, 0.0),
    (1, 128, 128, 2, 2, 16, True, 0, 10.0),
    (1, 1, 1, 14, 2, 64, True, 0, 0.0),
    (2, 7, 7, 14, 2, 64, True, 0, 0.0),
    (1, 1500, 1500, 14, 2, 64, True, 0, 0.0),
    (1, 300, 300, 10, 1, 256, True, 128, 0.0),
    (1, 200, 333, 10, 2, 128, False, 0, 0.0),
    # both sides of the tensor-core body's tiles (64 keys; 128 query rows
    # at dh 64, 64 at dh 256), at qwen2's heads (G = 7) and
    # recurrentgemma's (G = 10)
    *[(1, n, n, 14, 2, 64, True, 0, 0.0)
      for n in (15, 16, 17, 63, 65, 127, 128, 129)],
    *[(1, n, n, 10, 1, 256, True, 2048, 0.0)
      for n in (15, 16, 17, 63, 65, 127, 128, 129)],
    (1, 300, 300, 10, 1, 256, True, 100, 0.0),     # window ends mid-tile
    (2, 100, 257, 14, 2, 64, False, 0, 0.0),       # full, Sk != Sq
    (1, 257, 100, 14, 2, 64, False, 0, 0.0),
    # seamless-m4t-large-v2's encoder and cross-attention prefill (8
    # prompt tokens over 4096 frames); qwen2-vl-72b's heads
    (2, 512, 512, 16, 16, 64, False, 0, 0.0),
    (2, 8, 4096, 16, 16, 64, False, 0, 0.0),
    (2, 256, 256, 64, 8, 128, True, 0, 0.0),
])
def test_flash_kernel_matches_plain(cuda, b, sq, sk, hq, hkv, dh, causal,
                                    window, softcap, dtype):
    gen = torch.Generator(device="cuda").manual_seed(sq * dh + hq)
    q = _rand(gen, (b, sq, hq, dh), dtype)
    k = _rand(gen, (b, sk, hkv, dh), dtype)
    v = _rand(gen, (b, sk, hkv, dh), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    expect = ref.flash_attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    assert out.is_contiguous()
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)


def test_flash_kernel_reads_strided_views(cuda):
    """q, k and v as views of one fused (B, S, Hq + 2 Hkv, dh) projection,
    read in place through their strides; the output does not depend on
    q_block / kv_block."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    qkv = _rand(gen, (2, 333, 14 + 2 + 2, 64), torch.float32)
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    assert not q.is_contiguous() and not k.is_contiguous()
    out = ops.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    expect = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window=100)
    _assert_within_tolerance(out, expect)
    assert torch.equal(out, ops.flash_attention(q, k, v, window=100,
                                                q_block=64, kv_block=32))


def test_flash_wrapper_counts_launches_and_rejects_bad_inputs(cuda):
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = _rand(gen, (2, 9, 4, 16), torch.float32)
    k = _rand(gen, (2, 9, 2, 16), torch.float32)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, k)
    assert ops.LAUNCHES == {"ragged_decode": 0, "paged_decode": 0,
                            "flash_attention": 1}
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(2, 9, 3, 16), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :, :8], k[:, :, :, :8])
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :0], k, k)
    with pytest.raises(ValueError):
        wide = _rand(gen, (2, 9, 4, 32), torch.float32)
        ops.flash_attention(wide[..., ::2], k, k)
    with pytest.raises(RuntimeError, match="grad"):
        ops.flash_attention(q.requires_grad_(), k, k)
    assert ops.LAUNCHES["flash_attention"] == 1


def test_flash_bf16_wrapper_rejects_what_16_byte_copies_cannot_take(cuda):
    """The bf16 tensor-core body copies rows in 16-byte pieces: at a dh
    that is a multiple of 8, the strides and the data must allow it, or
    the wrapper raises before any launch."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = _rand(gen, (2, 9, 4, 16), torch.bfloat16)
    k = _rand(gen, (2, 9, 2, 16), torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):      # row stride 20
        wide = _rand(gen, (2, 9, 4, 20), torch.bfloat16)
        ops.flash_attention(wide[..., :16], k, k)
    with pytest.raises(ValueError, match="16-byte"):      # 2-byte offset
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                           device="cuda")
        ops.flash_attention(flat[1:].view(q.shape), k, k)
    assert ops.LAUNCHES["flash_attention"] == 0
    # views of a fused projection pass, and a dimension of size 1 is
    # never stepped over, whatever its stride
    qkv = _rand(gen, (1, 9, 8, 16), torch.bfloat16)
    q1 = qkv.as_strided((1, 9, 4, 16), (3, 128, 16, 1))
    k1, v1 = qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.flash_attention(q1, k1, v1)
    assert ops.LAUNCHES["flash_attention"] == 1
    expect = ref.flash_attention_ref(q1, k1, v1)
    _assert_within_tolerance(out, expect)
    _assert_rows_within_tolerance(out, expect)


def test_flash_bf16_wrapper_runs_dh_not_a_multiple_of_8_on_the_simt_body(
        cuda):
    """bf16 at a dh the 16-byte copies cannot take (12, smollm-360m's
    smoke dh 20) runs on the SIMT body with element loads, contiguous or
    as the strided views of a fused projection, within the bf16 limit of
    the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = _rand(gen, (2, 9, 4, 12), torch.bfloat16)
    k = _rand(gen, (2, 9, 2, 12), torch.bfloat16)
    qkv = _rand(gen, (2, 9, 8, 20), torch.bfloat16)
    wide = _rand(gen, (2, 9, 4, 20), torch.bfloat16)
    cases = [(q, k, k),                                          # dh 12
             (wide, qkv[:, :, 4:6], qkv[:, :, 6:]),              # dh 20
             (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])]     # views
    ops.reset_launch_counts()
    for qc, kc, vc in cases:
        out = ops.flash_attention(qc, kc, vc)
        expect = ref.flash_attention_ref(qc, kc, vc)
        assert out.dtype == torch.bfloat16 and out.shape == qc.shape
        _assert_within_tolerance(out, expect)
        _assert_rows_within_tolerance(out, expect)
    assert ops.LAUNCHES["flash_attention"] == len(cases)


def test_flash_grid_limit_is_the_launching_bodys(cuda):
    """B * Hq is the fp32 body's grid.y, at most 65535; the bf16 body puts
    it on grid.x, so the same rows launch there."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    q = _rand(gen, (65536, 1, 1, 8), torch.float32)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.flash_attention(q, q, q)
    q = q.bfloat16()
    out = ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == 1
    _assert_within_tolerance(out, ref.flash_attention_ref(q, q, q))


@pytest.mark.parametrize("length", [1024, 1500])
def test_model_prefill_runs_the_flash_kernel(cuda, length):
    """On the card every attention layer's prefill launches the kernel
    once; logits and the filled cache match the CPU's (chunked attention
    there) at fp32."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(length).integers(
        1, 128, (2, length)), dtype=torch.int32)
    got = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, dev)
        cache = m.init_cache(2, 2048)
        ops.reset_launch_counts()
        logits, cache = m.prefill(m.prepare_params(params),
                                  {"tokens": toks.to(dev)}, cache)
        assert ops.LAUNCHES["flash_attention"] == (
            cfg.n_layers if dev == "cuda" else 0)
        got[dev] = (logits.cpu(),
                    cache["stack"]["body"][0]["attn"]["k"].cpu())
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
def test_engine_long_prompt_on_card_matches_cpu(cuda, pages):
    """A round with a prompt of 1100 tokens (bucket 2048: the flash kernel
    on the card, chunked attention on the CPU) serves the CPU's tokens at
    fp32."""
    from repro_torch.core.plan import EndpointPlan, SharingVector
    from repro_torch.serve.engine import ContinuousEngine, Request
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    runs = []
    for dev in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, EndpointPlan(
            vector=SharingVector(pages=4 if pages else 1), n_slots=3,
            max_len=2048, decode_horizon=4, executor="continuous"),
            device=dev)
        rng = np.random.default_rng(7)
        for rid, n in enumerate((1100, 30, 500, 12, 1024)):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, 128, size=n).astype(np.int32), max_new_tokens=8))
        ops.reset_launch_counts()
        done = {r.rid: r.output for r in eng.run()}
        assert ops.LAUNCHES["flash_attention"] == (
            cfg.n_layers * eng.stats["prefills"] if dev == "cuda" else 0)
        runs.append((done, eng.admit_order, eng.retire_steps))
    assert runs[0] == runs[1]


# ----- fused horizon graphs ----------------------------------------------------

def _horizon_engine(arch, pages, horizon):
    """A smoke-config engine at fp32 on the card, not started."""
    from repro_torch.core.plan import EndpointPlan, SharingVector
    from repro_torch.serve.engine import ContinuousEngine
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    return ContinuousEngine(cfg, params, EndpointPlan(
        vector=SharingVector(pages=4 if pages else 1), n_slots=3,
        max_len=48, decode_horizon=horizon, executor="continuous",
        page_budget=8 if pages else None), device="cuda")


def _horizon_run(eng, on_horizon=None):
    """Serve ``_submit_requests``' requests on the started ``eng``; ->
    (tokens, admission order, retirement steps, the horizon lengths
    launched in order, launch counts of the run).  ``on_horizon(n)`` runs
    after each horizon of ``n`` steps."""
    _submit_requests(eng)
    steps, run = [], eng._run_horizon

    def counted(n):
        trace = run(n)
        steps.append(n)
        if on_horizon is not None:
            on_horizon(n)
        return trace

    eng._run_horizon = counted
    ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()
    n_done = len(eng.done)
    done = {r.rid: r.output for r in eng.run()[n_done:]}
    torch.cuda.synchronize()
    eng._run_horizon = run
    # a replay adds its capture's launches to both counters alike
    by_kernel = dict.fromkeys(ops.LAUNCHES, 0)
    for (name, _, _), n in ops.SHAPE_LAUNCHES.items():
        by_kernel[name] += n
    assert by_kernel == ops.LAUNCHES
    return (done, eng.admit_order[n_done:], eng.retire_steps, steps,
            dict(ops.LAUNCHES, **rglru_ops.LAUNCHES))


def _expected_launches(eng, steps):
    """Each decode step launched runs the decode kernel in every attention
    layer of a paging-capable stack; each prefill its prefill kernels."""
    cfg = eng.cfg
    kinds = cfg.pattern_for(cfg.n_layers)
    n_rglru = sum(k == "rglru" for k in kinds)
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    expect = {"ragged_decode": 0, "paged_decode": 0,
              "flash_attention": n_attn * eng.stats["prefills"],
              "rglru_scan": n_rglru * eng.stats["prefills"]}
    if eng.model.supports_paged_cache:
        name = "paged_decode" if eng.paged else "ragged_decode"
        expect[name] = cfg.n_layers * sum(steps)
    return expect


def _static_buffers(eng):
    from repro_torch.models.params import tree_leaves
    cache = eng._cache
    return (tree_leaves(cache["stack"]) + [cache["idx"]]
            + ([cache["pt"]] if "pt" in cache else [])
            + list(eng._dev_state.values())
            + list(eng._horizons.trace.values()))


GRAPH_CASES = [pytest.param("qwen2-0.5b", False, id="qwen2-contiguous"),
               pytest.param("qwen2-0.5b", True, id="qwen2-pages4"),
               pytest.param("recurrentgemma-2b", False, id="recurrentgemma"),
               pytest.param("granite-moe-1b-a400m", False,
                            id="granite-contiguous"),
               pytest.param("granite-moe-1b-a400m", True, id="granite-pages4"),
               pytest.param("deepseek-moe-16b", True, id="deepseek-pages4"),
               pytest.param("xlstm-1.3b", False, id="xlstm")]


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_horizon_graphs_serve_the_eager_tokens(cuda, arch, pages):
    """Every fused horizon replays its graph and serves the tokens of the
    eager body (the engine's horizon runner swapped for it); both modes
    launch the decode kernel layers x steps launched."""
    runs = {}
    for eager in (False, True):
        eng = _horizon_engine(arch, pages, horizon=4)
        eng.start()
        if eager:
            eng._run_horizon = eng._horizons.body
        done, order, retire, steps, launches = _horizon_run(eng)
        assert launches == _expected_launches(eng, steps), eager
        assert eng.graph_count() == (0 if eager else len(set(steps)))
        runs[eager] = done, order, retire
    assert runs[False] == runs[True]


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_compile_count_equals_the_cpu_count(cuda, arch, pages):
    """The execs signal is the same on the card and on the CPU: the same
    session gives the same specializations per entry, whatever graphs
    the card captured."""
    from repro_torch.serve import engine as serve_engine
    counts = {}
    for device in ("cpu", "cuda"):
        serve_engine.clear_exec_groups()
        card = _horizon_engine(arch, pages, horizon=4)
        eng = card if device == "cuda" else type(card)(
            card.cfg, Model(card.cfg, "cpu").init(
                torch.Generator().manual_seed(0)), card.plan, device="cpu")
        eng.start()
        _submit_requests(eng)
        eng.run()
        counts[device] = ({e: eng.group.count(e)
                           for e in serve_engine.ENTRIES},
                          eng.compile_count())
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"][1] > 0


def test_compile_count_grows_only_at_a_new_horizon_length(cuda):
    """At most K graphs, one more exactly when a horizon length first
    appears; a second run on the same engine captures nothing; after its
    capture a horizon length never calls ``Model.decode_horizon`` again
    (the warm-up's one step aside)."""
    import collections
    eng = _horizon_engine("qwen2-0.5b", False, horizon=4)
    calls = collections.Counter()
    body = eng.model.decode_horizon

    def counted(*args, n_steps=None, **kw):
        calls[n_steps] += 1
        return body(*args, n_steps=n_steps, **kw)

    eng.model.decode_horizon = counted
    eng.start()
    assert calls == {1: 1} and eng.graph_count() == 0         # warm-up
    seen = []

    def check(n):
        seen.append(n)
        assert eng.graph_count() == len(set(seen))

    first = _horizon_run(eng, check)
    captured = eng.graph_count()
    assert 1 <= captured <= eng.decode_horizon
    assert len(seen) > captured                                # replays
    again = _horizon_run(eng, check)
    assert eng.graph_count() == captured
    assert again[0] == first[0]
    assert calls == collections.Counter(set(seen)) + collections.Counter(
        {1: 1})


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_capture_with_live_slots_changes_nothing(cuda, arch, pages):
    """A capture in the middle of a run, with live slots, writes no static
    buffer, and the run serves the eager body's tokens."""
    eng = _horizon_engine(arch, pages, horizon=8)
    eng.start()
    eng._run_horizon = eng._horizons.body
    expect = _horizon_run(eng)[:3]
    eng = _horizon_engine(arch, pages, horizon=8)
    eng.start()
    forced = []

    def capture_one_more(_):
        graphs = eng._horizons.graphs
        if forced or len(graphs) < 2:
            return
        n = min(set(range(1, 9)) - graphs.keys())
        assert eng.n_active > 0
        before = [t.clone() for t in _static_buffers(eng)]
        graphs[n] = eng._horizons._capture(n)
        torch.cuda.synchronize()
        for a, b in zip(before, _static_buffers(eng)):
            assert torch.equal(a, b)
        forced.append(n)

    got = _horizon_run(eng, capture_one_more)
    assert forced
    assert got[:3] == expect


# ----- handoff, export and evacuation on engines with horizon graphs ---------

def _graph_or_eager(arch, pages, eager):
    """``_horizon_engine`` at K=4, started; ``eager`` swaps its horizon
    runner for the eager body."""
    eng = _horizon_engine(arch, pages, horizon=4)
    eng.start()
    if eager:
        eng._run_horizon = eng._horizons.body
    return eng


def _outputs(requests):
    return {r.rid: list(r.output) for r in requests}


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_handoff_into_a_graph_engine_serves_the_eager_tokens(cuda, arch,
                                                             pages):
    """KV payloads from ``prefill_only`` land in an engine whose horizons
    replay graphs; the tokens equal the eager body's on the same
    payloads, and the graph run captured at least one graph."""
    runs = {}
    for eager in (False, True):
        prefill = _horizon_engine(arch, pages, horizon=4)
        requests = _requests()
        for req in requests:
            req.kv = prefill.prefill_only(req)
        eng = _graph_or_eager(arch, pages, eager)
        for req in requests:
            eng.submit(req)
        runs[eager] = _outputs(eng.run())
        torch.cuda.synchronize()
        assert eng.stats["prefills"] == 0
        assert eng.graph_count() >= (0 if eager else 1)
    assert runs[False] == runs[True]
    assert len(runs[False]) == 11


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_export_mid_run_resumes_the_eager_tokens(cuda, arch, pages):
    """Engine A serves 2 horizons and exports every live session; engine
    B admits the payloads and A's queue and finishes.  With graphs on
    both the tokens equal the eager body's; A's pages all return."""
    runs = {}
    for eager in (False, True):
        a = _graph_or_eager(arch, pages, eager)
        _submit_requests(a)
        a.admit_waiting()
        a.step()
        a.admit_waiting()
        a.step()
        handoffs = a.export_sessions()
        assert handoffs and a.n_active == 0
        if a.paged:
            assert a.page_pool.live_pages == 0
        queued = list(a.queue)
        a.queue.clear()
        by_rid = {r.rid: r for r in _requests()}
        b = _graph_or_eager(arch, pages, eager)
        for h in handoffs:
            req = by_rid[h.rid]
            req.kv = h
            b.submit(req)
        for req in queued:
            b.submit(req)
        runs[eager] = {**_outputs(a.done), **_outputs(b.run())}
        torch.cuda.synchronize()
    assert runs[False] == runs[True]
    assert len(runs[False]) == 11


@pytest.mark.parametrize("arch,pages", GRAPH_CASES)
def test_evacuate_then_reserve_keeps_the_graphs(cuda, arch, pages):
    """``evacuate``, at the first horizon that leaves both live and
    queued requests, returns them; the engine then serves fresh copies
    of all the requests with the graphs it had (still there) and the
    eager body's tokens."""
    runs = {}
    for eager in (False, True):
        eng = _graph_or_eager(arch, pages, eager)
        _submit_requests(eng)
        while True:
            eng.admit_waiting()
            eng.step()
            if eng.n_active and eng.queue:
                break
        graphs = dict(eng._horizons.graphs)
        live, queued = eng.evacuate()
        assert live and queued and eng.n_active == 0 and not eng.queue
        assert all(not r.output for r in queued)
        if eng.paged:
            assert eng.page_pool.live_pages == 0
        n_done = len(eng.done)
        for req in _requests():
            eng.submit(req)
        runs[eager] = ([list(r.output) for r in live],
                       _outputs(eng.run()[n_done:]))
        torch.cuda.synchronize()
        assert all(eng._horizons.graphs[n] is g for n, g in graphs.items())
    assert runs[False] == runs[True]


# ----- the fleet: engines of one exec group share one graph memory pool -----

def _fleet_serve(arch, device, levels, n_workers, **kw):
    """The first burst of the canonical bursty trace through a smoke
    fleet at fp32 (4 slots a worker, max_len 64, K 4); -> (tokens,
    client)."""
    from repro_torch.core.plan import SharingVector
    from repro_torch.serve import connect
    from repro_torch.serve.fabric import canonical_bursty_trace
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    client = connect(cfg, SharingVector(*levels), params=params,
                     device=device, n_workers=n_workers, n_slots=4,
                     max_len=64, decode_horizon=4, **kw)
    for a in canonical_bursty_trace()[:24]:
        rng = np.random.default_rng(a.rid)
        client.submit(rng.integers(1, cfg.vocab, size=a.prompt_len)
                      .astype(np.int32), max_new_tokens=a.max_new_tokens,
                      at_ns=a.t_ns, session=a.session)
    out = client.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, client


FLEET_CASES = [
    pytest.param("qwen2-0.5b", (4, 4, 4, 1), 4, {}, id="qwen2-diag4"),
    pytest.param("qwen2-0.5b", (1, 1, 1, 4), 4, dict(page_size=16),
                 id="qwen2-diag1-pages4"),
    pytest.param("qwen2-0.5b", (2, 2, 2, 1), 4,
                 dict(roles="2P+2D", faults="crash@0.6ms:w2"),
                 id="qwen2-2P+2D-crash"),
    pytest.param("qwen2-0.5b", (2, 2, 2, 1), 4,
                 dict(migrations=[(150_000.0, 1, 3)], adaptive=True,
                      adapt_window_ns=100_000.0),
                 id="qwen2-migration-adaptive"),
    pytest.param("recurrentgemma-2b", (2, 2, 2, 1), 2, {},
                 id="recurrentgemma-colocated"),
    pytest.param("recurrentgemma-2b", (2, 2, 2, 1), 2, dict(roles="1P+1D"),
                 id="recurrentgemma-1P+1D"),
]


@pytest.mark.parametrize("arch,levels,n_workers,kw", FLEET_CASES)
def test_fleet_on_card_matches_cpu(cuda, arch, levels, n_workers, kw):
    """A fleet on the card (kernels, every worker's horizons replayed as
    graphs captured into its exec group's pool) serves the CPU fleet's
    tokens at fp32, with the same virtual schedule; every engine runs on
    the card over one weight copy, and the engines of one exec group
    report one probe key."""
    from repro_torch.models.params import tree_leaves
    if "faults" in kw:
        from repro_torch.serve.recovery import RecoveryPolicy
        kw = dict(kw, recovery=RecoveryPolicy(deadline_ns=600_000.0))
    cpu, cpu_client = _fleet_serve(arch, "cpu", levels, n_workers, **kw)
    card, client = _fleet_serve(arch, "cuda", levels, n_workers, **kw)
    assert card == cpu and len(card) == 24
    rep, cpu_rep = client.report, cpu_client.report
    assert [(c.rid, c.worker, c.t_done_ns) for c in rep.completions] == \
        [(c.rid, c.worker, c.t_done_ns) for c in cpu_rep.completions]
    assert (rep.handoffs, rep.migrations, rep.detections, rep.recovered,
            rep.failed) == (cpu_rep.handoffs, cpu_rep.migrations,
                            cpu_rep.detections, cpu_rep.recovered,
                            cpu_rep.failed)
    engines = [w.engine for w in client.workers]
    assert all(e.device.type == "cuda" for e in engines)
    first = tree_leaves(engines[0].params)
    assert all(a is b for e in engines[1:]
               for a, b in zip(tree_leaves(e.params), first))
    assert all(0 <= e.graph_count() <= e.decode_horizon for e in engines)
    assert sum(e.graph_count() for e in engines) >= 1
    keys = {w.compile_probe()[0] for w in client.workers}
    assert len(keys) == len({id(e.group) for e in engines})
    assert rep.metrics.total("exec.jit_compiles") == sum(
        g.compile_count() for g in {id(e.group): e.group
                                    for e in engines}.values())


def test_shared_pool_interleaved_replays_equal_each_engines_eager_body(
        cuda):
    """Two engines of one exec group capture their horizon graphs into
    the group's one memory pool and step in turns (one horizon of A, one
    of B, ...), each step ending in its host sync, as the fleet steps
    them.  Each serves, on every token, what its own eager body serves on
    the same requests; no graph's replay disturbs the other engine's."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(5)

    def requests(rid0):
        return [Request(rid=rid0 + i, prompt=rng.integers(
            1, 128, size=int(n)).astype(np.int32),
            max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(rng.integers(3, 30, 9),
                                           rng.integers(1, 30, 9)))]

    sets = {"a": requests(0), "b": requests(100)}
    eager = {}
    for name, reqs in sets.items():
        eng = _horizon_engine("qwen2-0.5b", False, horizon=4)
        eng.start()
        eng._run_horizon = eng._horizons.body
        for r in reqs:
            eng.submit(Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens))
        eager[name] = _outputs(eng.run())
    a = _horizon_engine("qwen2-0.5b", False, horizon=4)
    b = _horizon_engine("qwen2-0.5b", False, horizon=4)
    assert a.group is b.group
    engines = {"a": a, "b": b}
    for name, eng in engines.items():
        eng.start()
        for r in sets[name]:
            eng.submit(Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens))
    pool = None
    while any(e.has_work for e in engines.values()):
        for eng in engines.values():
            if eng.has_work:
                eng.admit_waiting()
                eng.step()
                if eng.group._pool is not None:
                    pool = eng.group._pool
    torch.cuda.synchronize()
    assert pool is not None and a.group._pool == pool
    assert a.graph_count() >= 1 and b.graph_count() >= 1
    assert a.group.captures >= a.graph_count() + b.graph_count()
    assert _outputs(a.done) == eager["a"]
    assert _outputs(b.done) == eager["b"]


# ----- admission graphs: one CUDA graph per prefill bucket --------------------

ADMISSION_CASES = [
    pytest.param("qwen2-0.5b", False, id="qwen2-contiguous"),
    pytest.param("qwen2-0.5b", True, id="qwen2-pages4"),
    pytest.param("granite-moe-1b-a400m", False, id="granite-contiguous"),
    pytest.param("granite-moe-1b-a400m", True, id="granite-pages4")]


def _admission_buffers(eng):
    """Every static buffer an admission round reads or writes: the
    cache, ``idx``, ``pt``, the device state and the round's own inputs
    and first tokens (``AdmissionGraphs``)."""
    from repro_torch.models.params import tree_leaves
    cache, adm = eng._cache, eng._admissions
    out = (tree_leaves(cache["stack"]) + [cache["idx"]]
           + ([cache["pt"]] if "pt" in cache else [])
           + list((eng._dev_state or {}).values())
           + [adm.tokens[b] for b in sorted(adm.tokens)]
           + [adm.rows, adm.first] + ([adm.pt] if adm.pt is not None
                                      else []))
    return out


def _rounds_counted(eng, rounds):
    """Wrap ``eng._run_admission`` so that ``rounds`` receives, per
    round, its bucket and the flash launches it added."""
    run = eng._run_admission

    def counted(bucket):
        before = ops.LAUNCHES["flash_attention"]
        first = run(bucket)
        rounds.append((bucket, ops.LAUNCHES["flash_attention"] - before))
        return first

    eng._run_admission = counted


@pytest.mark.parametrize("arch,pages", ADMISSION_CASES)
def test_admission_graphs_equal_the_eager_body_bit_for_bit(cuda, arch,
                                                           pages):
    """Two engines on the same requests, one admitting through its
    bucket graphs, the other through the eager body: after every
    admission round and every horizon, every cache leaf, ``idx``, ``pt``
    and state tensor of the two are equal bit for bit.  The graph engine
    holds one admission graph per bucket used; each round adds the flash
    kernel's launches once per attention layer."""
    engines = [_horizon_engine(arch, pages, horizon=4) for _ in range(2)]
    rounds = {}
    for eng, eager in zip(engines, (False, True)):
        eng.start()
        _submit_requests(eng)
        if eager:
            eng._run_admission = eng._admissions.body
        rounds[eager] = []
        _rounds_counted(eng, rounds[eager])
    graph, eager = engines

    def state(eng):
        from repro_torch.models.params import tree_leaves
        cache = eng._cache
        return (tree_leaves(cache["stack"]) + [cache["idx"]]
                + ([cache["pt"]] if "pt" in cache else [])
                + list(eng._dev_state.values()))

    while graph.has_work or eager.has_work:
        for eng in engines:
            eng.admit_waiting()
        torch.cuda.synchronize()
        for a, b in zip(state(graph), state(eager)):
            assert torch.equal(a, b)
        for eng in engines:
            eng.step()
        for a, b in zip(state(graph), state(eager)):
            assert torch.equal(a, b)
    assert _outputs(graph.done) == _outputs(eager.done)
    assert rounds[False] == rounds[True] and len(rounds[False]) >= 3
    buckets = {b for b, _ in rounds[False]}
    assert graph.admission_graph_count() == len(buckets) >= 2
    assert eager.admission_graph_count() == 0
    layers = graph.cfg.n_layers
    assert all(n == layers for _, n in rounds[False])


@pytest.mark.parametrize("arch,pages", ADMISSION_CASES)
def test_admission_graph_count_holds_on_a_second_run(cuda, arch, pages):
    """A second run of the same requests on the same engine uses the
    same buckets: it captures no admission graph, replays the ones it
    has, and serves the first run's tokens."""
    eng = _horizon_engine(arch, pages, horizon=4)
    eng.start()
    runs = []
    for _ in range(2):
        n_done = len(eng.done)
        _submit_requests(eng)
        runs.append(_outputs(eng.run()[n_done:]))
        graphs = dict(eng._admissions.graphs)
        if len(runs) == 1:
            first = graphs
    assert runs[0] == runs[1]
    assert graphs.keys() == first.keys() and all(
        graphs[b] is first[b] for b in graphs)
    assert 1 <= eng.admission_graph_count() <= len(eng.prefill_buckets)


@pytest.mark.parametrize("arch,pages", ADMISSION_CASES)
def test_admission_buffers_survive_handoff_export_evacuate_regroup(
        cuda, arch, pages):
    """An engine with admission and horizon graphs takes half its
    requests as KV payloads, regroups (slots, pages, exec group), exports
    a live session and evacuates, then serves every request afresh:
    every static buffer an admission round touches keeps its address
    throughout, the graphs it had are kept, and the tokens equal an
    engine's whose admission runs the eager body."""
    runs = {}
    for eager in (False, True):
        eng = _graph_or_eager(arch, pages, eager=False)
        if eager:
            eng._run_admission = eng._admissions.body
        prefill = _horizon_engine(arch, pages, horizon=4)
        requests = _requests()
        for req in requests[: len(requests) // 2]:
            req.kv = prefill.prefill_only(req)
        for req in requests:
            eng.submit(req)
        fixed = [t.data_ptr() for t in _admission_buffers(eng)]

        def same():
            return [t.data_ptr() for t in _admission_buffers(eng)] == fixed

        eng.admit_waiting()
        eng.step()
        assert same()
        graphs = dict(eng._admissions.graphs)
        assert eng.regroup(slot_level=2, exec_group=1,
                           page_level=2 if eng.paged else None)
        assert same() and eng._admissions.group is eng.group
        while not (eng.n_active and eng.queue):
            eng.admit_waiting()
            eng.step()
        slot = next(s for s, r in enumerate(eng._slot_req) if r is not None)
        handoff = eng.export_session(slot)
        live, queued = eng.evacuate()
        assert same()
        assert all(eng._admissions.graphs[b] is g for b, g in graphs.items())
        n_done = len(eng.done)
        for req in _requests():
            eng.submit(req)
        again = _outputs(eng.run()[n_done:])
        torch.cuda.synchronize()
        assert same()
        runs[eager] = (handoff.next_tok, [list(r.output) for r in live],
                       again)
        if not eager:
            assert eng.admission_graph_count() >= 1
    assert runs[False] == runs[True]


# ----- training -------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,c", [(2, 300, 200), (1, 1025, 64),
                                   (1, 2048, 2560)])
def test_rglru_function_grads_match_plain(cuda, b, t, c, x_dtype):
    """The scan's autograd Function on the card (forward, then the same
    kernel in reverse time) against torch autograd through ``ref.py``:
    da and dx within the kernel's limits; one launch each way."""
    gen = torch.Generator(device="cuda").manual_seed(t + c)
    a = 0.9 + 0.099 * torch.rand((b, t, c), generator=gen, device=cuda)
    x = _rand(gen, (b, t, c), x_dtype)
    g = _rand(gen, (b, t, c), x_dtype)
    a1, x1 = a.clone().requires_grad_(), x.clone().requires_grad_()
    rglru_ops.reset_launch_counts()
    da, dx = torch.autograd.grad(rglru_ops.rglru_scan(a1, x1), (a1, x1), g)
    assert rglru_ops.LAUNCHES["rglru_scan"] == 2
    assert rglru_ops.BACKWARD_LAUNCHES == {"scan_backward": 1}
    a2, x2 = a.clone().requires_grad_(), x.clone().requires_grad_()
    ea, ex = torch.autograd.grad(rglru_ref.rglru_scan_ref(a2, x2), (a2, x2),
                                 g)
    assert da.dtype == torch.float32 and dx.dtype == x_dtype
    for got, want in ((da, ea), (dx, ex)):
        if x_dtype == torch.bfloat16:
            tol = BF16_REL_TOL * want.float().abs().max().item()
        else:
            tol = 1e-5 * max(1.0, want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol


def test_attention_kernels_refuse_grad_requiring_inputs(cuda):
    """A CUDA input that requires grad raises under grad mode in every
    attention wrapper (the kernels are forward only: autograd would lose
    the gradient); under no_grad the same call launches."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _rand(gen, (2, 1, 4, 16), torch.float32)
    k = _rand(gen, (2, 32, 2, 16), torch.float32)
    cur = torch.tensor([3, 31], dtype=torch.int32, device=cuda)
    pages = k.reshape(8, 8, 2, 16)
    table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    qp = _rand(gen, (2, 9, 4, 16), torch.float32)
    kp = _rand(gen, (2, 9, 2, 16), torch.float32)
    calls = [lambda q_: ops.flash_decode_attention(q_, k, k, cur),
             lambda q_: ops.paged_flash_decode_attention(q_, pages, pages,
                                                         table, cur),
             lambda q_: ops.flash_attention(q_, kp, kp)]
    for call, q_ in zip(calls, (q, q, qp)):
        with pytest.raises(RuntimeError, match="requires grad"):
            call(q_.clone().requires_grad_())
        with torch.no_grad():
            call(q_.clone().requires_grad_())


TRAIN_ARCHS = ["qwen2-0.5b", "recurrentgemma-2b", "granite-moe-1b-a400m",
               "xlstm-1.3b", "seamless-m4t-large-v2", "qwen2-vl-72b"]


def _smoke_batch(cfg, gen, rows=2, length=32):
    """(rows, length) tokens and labels; over 24 frames for an enc-dec
    model; embeddings instead of tokens for embeddings input."""
    batch = {k: torch.randint(0, cfg.vocab, (rows, length), generator=gen)
             for k in ("tokens", "labels")}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn((rows, 24, cfg.d_model),
                                          generator=gen)
    elif cfg.input_mode == "embeddings":
        batch["embeds"] = torch.randn((rows, length, cfg.d_model),
                                      generator=gen)
        del batch["tokens"]
    return batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One train step's loss and gradients at fp32 on the card equal the
    CPU's: the loss within 1e-5 relative, each gradient leaf within 1e-4
    of its largest magnitude (floored at 1e-3 of the largest gradient:
    an exactly-zero gradient holds rounding noise).  Training never
    launches the flash kernel; recurrentgemma's scan runs on the card."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.params import tree_leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = _smoke_batch(cfg, torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        rglru_ops.reset_launch_counts()
        p = tree_map(lambda t: t.to(dev), params, torch.is_tensor)
        b = {k: v.to(dev) for k, v in batch.items()}
        out[dev] = value_and_grad(Model(cfg, dev), p, b)
        assert ops.LAUNCHES["flash_attention"] == 0
        if dev == "cuda" and arch == "recurrentgemma-2b":
            assert rglru_ops.LAUNCHES["rglru_scan"] > 0
    (l_cpu, _), g_cpu = out["cpu"]
    (l_gpu, _), g_gpu = out["cuda"]
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    g_cpu = tree_leaves(g_cpu, torch.is_tensor)
    g_gpu = tree_leaves(g_gpu, torch.is_tensor)
    floor = 1e-3 * max(g.abs().max().item() for g in g_cpu)
    for a, b in zip(g_gpu, g_cpu):
        scale = max(b.abs().max().item(), floor)
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_encdec_and_embeds_on_card_match_cpu(cuda, arch):
    """The smoke config at fp32: a prefill of 2 rows (over 24 frames, or
    of embeddings) and 8 decode steps (greedy tokens fed back, or the
    steps' embeddings) on the card equal the CPU's: the same greedy
    tokens, logits within 1e-4 of the largest.  The card launches flash
    once an attention layer (encoder, decoder self and cross) per prefill
    and ragged decode once a decoder attention (self and cross) per
    step."""
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    batch = _smoke_batch(cfg, gen, length=16)
    del batch["labels"]
    steps = torch.randn((8, 2, cfg.d_model), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, dev)
        p = m.prepare_params(params)
        ops.reset_launch_counts()
        logits, cache = m.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                                  m.init_cache(2, 32, enc_len=24))
        chain, toks = [logits.cpu()], []
        for i in range(8):
            if cfg.is_encdec:
                tok = logits.argmax(-1).int()
                logits, cache = m.decode_step(p, cache, tokens=tok)
            else:
                logits, cache = m.decode_step(p, cache,
                                              embeds=steps[i].to(dev))
            toks.append(logits.argmax(-1).cpu())
            chain.append(logits.cpu())
        out[dev] = torch.stack(chain), torch.stack(toks), dict(ops.LAUNCHES)
    (l_cpu, t_cpu, c_cpu), (l_gpu, t_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert not any(c_cpu.values())
    decoder = cfg.n_layers * (2 if cfg.is_encdec else 1)
    assert c_gpu == {"flash_attention": cfg.n_enc_layers + decoder,
                     "ragged_decode": 8 * decoder, "paged_decode": 0}
    assert torch.equal(t_gpu, t_cpu)
    assert (l_gpu - l_cpu).abs().max().item() <= \
        1e-4 * l_cpu.abs().max().item()


def _plain_norm(p, x, kind):
    """The norm as serving computed it before it became a Function."""
    from repro_torch.models.layers import _row_stats
    dt = x.dtype
    mean, inv = _row_stats(x, kind)
    if kind == "rmsnorm":
        return x * inv.to(dt) * p["scale"].to(dt)
    xhat = (x - mean.to(dt)) * inv.to(dt)
    return xhat * p["scale"].to(dt) + p["bias"].to(dt)


def test_serving_tokens_unchanged_by_the_norm_function(cuda, monkeypatch):
    """bf16 prefill and decode logits on the card are bit-equal with the
    norm Function and with the plain formula it replaced."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer
    cfg = get_smoke_config("qwen2-0.5b")
    m = Model(cfg, "cuda")
    params = m.prepare_params(m.init(torch.Generator("cuda").manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab, (2, 20), device=cuda)

    def serve():
        with torch.no_grad():
            cache = m.init_cache(2, 32)
            logits, cache = m.prefill(params, {"tokens": tokens}, cache)
            outs = [logits]
            for _ in range(4):
                logits, cache = m.decode_step(params, cache,
                                              logits.argmax(-1))
                outs.append(logits)
        return torch.stack(outs)

    with_function = serve()
    monkeypatch.setattr(transformer, "apply_norm", _plain_norm)
    monkeypatch.setattr(model_mod, "apply_norm", _plain_norm)
    assert torch.equal(serve(), with_function)


def test_hooked_decode_step_equals_the_unhooked_on_the_card(cuda):
    """fp32 smoke qwen2: a decode step with ``make_shard_fn`` over a
    (1, 1) mesh of a one-process NCCL group, every activation made a
    DTensor and redistributed, equals the unhooked step bit for bit, and
    both launch the ragged kernel once a layer."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import fsdp_tp_sp_rules, make_shard_fn
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        inner = make_shard_fn(fsdp_tp_sp_rules(), mesh)

        def shard_fn(a, *names):
            d = DTensor.from_local(a, mesh, [Replicate(), Replicate()])
            return inner(d, *names).to_local()

        cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                  compute_dtype="float32")
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        tok = torch.arange(4, dtype=torch.int32, device=cuda) + 3
        outs = []
        for fn in (None, shard_fn):
            kw = {} if fn is None else {"shard_fn": fn}
            cache = model.init_cache(4, 32)
            _, cache = model.prefill(params, {"tokens": tok[:, None].expand(
                4, 6).contiguous()}, cache, **kw)
            ops.reset_launch_counts()
            logits, cache = model.decode_step(params, cache, tokens=tok,
                                              **kw)
            assert ops.LAUNCHES["ragged_decode"] == cfg.n_layers
            outs.append((logits, cache["stack"]))
        assert torch.equal(outs[0][0], outs[1][0])
        from repro_torch.models.params import tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(outs[0][1], torch.is_tensor),
            tree_leaves(outs[1][1], torch.is_tensor)))
    finally:
        dist.destroy_process_group()


def test_lower_cell_runs_beside_the_card(cuda):
    """The dry run of one cell in a subprocess (its fake process group
    cannot share a process with NCCL) on the card's machine."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    code = ("import json\n"
            "from repro_torch.launch import dryrun\n"
            "rec = dryrun.run_one('qwen2-0.5b', 'decode_32k', 'single')\n"
            "print('REC ' + json.dumps(rec))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads(next(l for l in res.stdout.splitlines()
                          if l.startswith("REC "))[4:])
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["memory"]["argument_bytes"] > 0


# ----- the examples ----------------------------------------------------------

#: the stencil's card-against-CPU limit, times max(1, max |CPU|): fp32,
#: the same sums in the same order
STENCIL_TOL = 1e-5


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_at_its_smoke_defaults_on_the_card(cuda, name):
    """Each script's ``main`` at its defaults (the card; the two
    multi-rank scripts on a one-process NCCL group they join and leave)."""
    rglru_ops.reset_launch_counts()
    ops.reset_launch_counts()
    out = load_example(name).main([])
    if name == "train_endpoint_categories":
        assert len(set(out.values())) == 1
    elif name == "stencil_endpoints":
        assert out["messages_per_step"] == 2 and out["grid"].is_cuda
    elif name in ("quickstart", "serve_batched"):
        assert ops.LAUNCHES["ragged_decode"] > 0
        assert ops.LAUNCHES["flash_attention"] > 0


def test_example_serve_batched_card_tokens_equal_cpu(cuda):
    """At fp32 the wave and the three presets serve the CPU's tokens."""
    batched = load_example("serve_batched")
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    card, cpu = (batched.run(cfg, dev) for dev in ("cuda", "cpu"))
    assert list(card) == ["wave", *batched.PRESETS]
    for name in card:
        assert card[name]["tokens"] == cpu[name]["tokens"]


def test_example_stencil_card_equals_cpu(cuda):
    import torch.distributed as dist
    from repro_torch.launch.train import join_group
    stencil = load_example("stencil_endpoints")
    grids = {}
    for dev in ("cuda", "cpu"):
        join_group(dev)
        try:
            grids[dev] = stencil.run(dev)["grid"].cpu()
        finally:
            dist.destroy_process_group()
    limit = STENCIL_TOL * max(1.0, grids["cpu"].abs().max().item())
    assert (grids["cuda"] - grids["cpu"]).abs().max().item() <= limit


def test_legacy_continuous_engine_on_the_card_serves_the_plan_tokens(cuda):
    """``ContinuousEngine(cfg, w, n_slots=4, max_len=64,
    category=Category.STATIC)`` on the card (its default device) warns
    once and serves, at fp32, the tokens of the engine built from
    ``EndpointPlan.from_preset("static")`` and of the legacy engine on
    the CPU."""
    from repro_torch.core.endpoints import Category
    from repro_torch.core.plan import EndpointPlan
    from repro_torch.serve.engine import ContinuousEngine, Request
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (8, 16, 32, 16, 8, 16)]
    kw = dict(n_slots=4, max_len=64)
    with pytest.deprecated_call():
        legacy = ContinuousEngine(cfg, params, category=Category.STATIC,
                                  **kw)
    with pytest.deprecated_call():
        on_cpu = ContinuousEngine(cfg, params, category=Category.STATIC,
                                  device="cpu", **kw)
    planned = ContinuousEngine(cfg, params, EndpointPlan.from_preset(
        "static", executor="continuous", **kw), device=cuda)
    assert legacy.device.type == "cuda"
    outs = []
    ops.reset_launch_counts()
    for eng in (legacy, planned, on_cpu):
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=6))
        outs.append({r.rid: list(r.output) for r in eng.run()})
    assert outs[0] == outs[1] == outs[2]
    assert ops.LAUNCHES["flash_attention"] > 0
    assert ops.LAUNCHES["ragged_decode"] > 0


def test_bare_launcher_serves_through_the_wave_kernels(cuda, capsys):
    """The launcher with no engine flag serves the smoke config through
    the wave executor, prefill on the flash kernel and every decode step
    on the ragged decode kernel."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--smoke"])
    out = capsys.readouterr().out
    assert "executor=wave" in out
    assert "served 8 requests, 96 tokens" in out
    assert ops.LAUNCHES["flash_attention"] > 0
    assert ops.LAUNCHES["ragged_decode"] > 0
