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
                                  (2, 256)])
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
@pytest.mark.parametrize("g,dh,ps", [(2, 16, 8), (3, 20, 16), (7, 64, 64)])
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
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()                                  # warm up off capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_ops.rglru_scan(a, x)                  # warm up off capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rglru_ops.rglru_scan(a, x)
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
    """The bf16 kernel copies rows in 16-byte pieces: dh, the strides and
    the data must allow it, or the wrapper raises before any launch."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = _rand(gen, (2, 9, 4, 16), torch.bfloat16)
    k = _rand(gen, (2, 9, 2, 16), torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):      # dh % 8
        ops.flash_attention(q[..., :12].contiguous(),
                            k[..., :12].contiguous(), k[..., :12].contiguous())
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
    return (done, eng.admit_order[n_done:], eng.retire_steps, steps,
            dict(ops.LAUNCHES, **rglru_ops.LAUNCHES))


def _expected_launches(eng, steps):
    """Each decode step launched runs the decode kernel in every attention
    layer of a paging-capable stack; each prefill its prefill kernels."""
    cfg = eng.cfg
    n_rglru = sum(k == "rglru" for k in cfg.pattern_for(cfg.n_layers))
    expect = {"ragged_decode": 0, "paged_decode": 0,
              "flash_attention": (cfg.n_layers - n_rglru)
              * eng.stats["prefills"],
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
               pytest.param("recurrentgemma-2b", False, id="recurrentgemma")]


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
