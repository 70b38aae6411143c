"""The port's roofline arithmetic against the JAX reference (CPU, no
model runs): ``active_params`` and ``model_flops`` for all ten configs,
the four cells and 1, 256 and 512 cards, and ``model_bytes`` on one
shared record per kind, equal float for float; the three terms, the
bottleneck, the fit and the table over synthetic records with the H100's
constants.  Tolerances: exact, except where a term is a quotient of the
port's constants (1e-12 relative)."""

import json

import pytest

from repro.configs import ARCHS, get_config as jget_config
from repro.launch import roofline as jroofline
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.launch.shapes import SHAPES
from repro_torch.models.model import Model


def _rec(**kw):
    base = {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh_name": "single",
        "status": "ok", "n_chips": 256,
        "mesh": {"data": 16, "model": 16}, "rules": "tp", "accum_steps": 1,
        "cost": {"flops_per_device": 1e13, "bytes_per_device": 1e11},
        "collectives": {"total_bytes": 5e9, "total_count": 100},
        "memory": {"argument_bytes": 2 * 2**30, "temp_bytes": 8 * 2**30,
                   "output_bytes": 2**30, "alias_bytes": 2**30},
    }
    base.update(kw)
    return base


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
    for shape in SHAPES:
        for n_chips in (1, 256, 512):
            assert roofline.model_flops(cfg, shape, n_chips) == \
                jroofline.model_flops(jcfg, shape, n_chips), (shape, n_chips)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bytes_equal_the_reference(arch):
    """One record per kind, shared by both packages: a train cell under
    accumulation on the single mesh (tp, then fsdp_tp), a prefill and a
    decode cell on the multi mesh."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    records = [
        _rec(arch=arch, accum_steps=4),
        _rec(arch=arch, rules="fsdp_tp", accum_steps=2),
        _rec(arch=arch, shape="prefill_32k", n_chips=512,
             mesh={"pod": 2, "data": 16, "model": 16}),
        _rec(arch=arch, shape="decode_32k", n_chips=512,
             mesh={"pod": 2, "data": 16, "model": 16}),
    ]
    for rec in records:
        assert roofline.model_bytes(cfg, rec) == \
            jroofline.model_bytes(jcfg, rec), rec["shape"]
    decode = records[-1]
    assert roofline.read_bytes(decode) == \
        decode["memory"]["argument_bytes"]


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert 80e9 < roofline.HBM_BYTES < 2**37


def test_three_terms_bottleneck_and_fit():
    r = roofline.analyze_record(_rec())
    assert abs(r.compute_s - 1e13 / roofline.PEAK_FLOPS) <= \
        1e-12 * r.compute_s
    want = roofline.model_bytes(get_config("qwen2-0.5b"), _rec()) \
        / roofline.HBM_BW
    assert r.memory_s == want
    assert r.memory_hlo_s == 1e11 / roofline.HBM_BW
    assert r.collective_s == 5e9 / roofline.LINK_BW + 100 * 1e-6
    assert r.bottleneck == max(
        ("compute", r.compute_s), ("memory", r.memory_s),
        ("collective", r.collective_s), key=lambda t: t[1])[0]
    assert 0 < r.useful_ratio and r.fits_hbm
    assert r.peak_mem_gib == 10.0
    big = roofline.analyze_record(_rec(memory={
        "argument_bytes": 60 * 2**30, "temp_bytes": 30 * 2**30,
        "output_bytes": 0, "alias_bytes": 0}))
    assert not big.fits_hbm
    skipped = roofline.analyze_record({
        "arch": "a", "shape": "long_500k", "mesh_name": "single",
        "status": "skipped", "reason": "designed skip"})
    assert skipped.status == "skipped" and skipped.bottleneck == "-"


def test_load_rows_and_table(tmp_path):
    recs = [_rec(), _rec(shape="decode_32k", mesh_name="multi"),
            {"arch": "smollm-360m", "shape": "long_500k",
             "mesh_name": "single", "status": "skipped", "reason": "r"}]
    for i, rec in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    (tmp_path / "summary.json").write_text("{}")
    rows = roofline.load_rows(str(tmp_path))
    assert [(r.shape, r.status) for r in rows] == \
        [("train_4k", "ok"), ("long_500k", "skipped")]
    assert len(roofline.load_rows(str(tmp_path), mesh=None)) == 3
    table = roofline.markdown_table(rows).splitlines()
    assert len(table) == 4 and table[0].count("|") == 11
    assert "| smollm-360m | long_500k | - |" in table[3]


def test_meta_model_counts_like_the_reference():
    """The roofline's model is built on the meta device: no card, no
    storage, the reference's parameter count."""
    from repro.models.model import Model as JModel
    for arch in ("qwen2-0.5b", "deepseek-moe-16b"):
        m = Model(get_config(arch), device="meta")
        assert m.device.type == "meta"
        assert m.n_params() == JModel(jget_config(arch)).n_params()
