"""Roofline analysis over the dry-run records (the port of
``repro.launch.roofline``), with an NVIDIA H100 SXM's rates.

Per (arch x shape x mesh) cell:
  compute term    = FLOPs per card / peak bf16 FLOP/s
  memory term     = achievable-minimum bytes per card / HBM bandwidth
  collective term = collective bytes / link bandwidth + alpha per op
plus MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (inference) and
the MODEL_FLOPS / counted-FLOPs usefulness ratio.

The counted FLOPs and the no-fusion byte bound come from the dry run's
op counter (``launch/op_analysis.py``); collective bytes from the
gradient sync's bucket plan.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.shapes import SHAPES

#: bf16 dense tensor-core FLOP/s of one H100 SXM (NVIDIA H100 datasheet:
#: 1979 TFLOPS with sparsity, half that dense)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s of one H100 SXM (datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s per direction of one H100 SXM (datasheet: 900 GB/s
#: bidirectional)
LINK_BW = 450e9
ICI_ALPHA = 1e-6           # s per collective op (latency floor)
#: device memory of one H100 80GB HBM3 as CUDA reports it
#: (``torch.cuda.get_device_properties(0).total_memory``, printed by
#: ``chip_smoke.py`` phase 17)
HBM_BYTES = 85_017_493_504


def _meta_model(cfg: ArchConfig):
    from repro_torch.models.model import Model
    return Model(cfg, device="meta")


def active_params(cfg: ArchConfig) -> float:
    """Parameter count with routed experts scaled by top_k/n_routed."""
    from repro_torch.models.params import is_spec, tree_leaves
    specs = _meta_model(cfg).param_specs()
    total = 0.0
    for leaf in tree_leaves(specs, is_spec):
        n = float(np.prod(leaf.shape))
        if "expert" in leaf.axes and cfg.moe is not None:
            n *= cfg.moe.top_k / cfg.moe.n_routed
        total += n
    return total


def model_flops(cfg: ArchConfig, shape_name: str, n_chips: int) -> float:
    """Per-card 'useful' FLOPs: 6 N D (train) / 2 N D (prefill) /
    2 N B (decode) with N = active params."""
    cell = SHAPES[shape_name]
    n = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.batch * cell.seq
        return 6.0 * n * tokens / n_chips
    if cell.kind == "prefill":
        tokens = cell.batch * cell.seq
        return 2.0 * n * tokens / n_chips
    return 2.0 * n * cell.batch / n_chips


def model_bytes(cfg: ArchConfig, rec: dict) -> float:
    """Achievable-minimum per-card HBM traffic per step (ideal fusion):
    parameter reads (per microbatch under accumulation), optimizer state
    r/w, residual-stream activation save/reload, cache reads for decode.
    The op counter's byte count is kept as the no-fusion upper bound.
    Decode counts its arguments plus its outputs, and with the cache
    donated the outputs are the whole cache again (the reference's
    formula; ``read_bytes`` is the read-only bound)."""
    cell = SHAPES[rec["shape"]]
    mesh = rec["mesh"]
    n_chips = rec["n_chips"]
    dp = int(np.prod([v for k, v in mesh.items() if k in ("pod", "data")]))
    shards = n_chips if rec.get("rules") == "fsdp_tp" else \
        mesh.get("model", 1)
    n = _meta_model(cfg).n_params()
    params_chip = n * 4.0 / shards
    accum = rec.get("accum_steps", 1)

    if cell.kind == "train":
        # fwd+bwd param reads per microbatch + grads + Adam m/v r/w
        traffic = accum * 2 * params_chip + 10 * params_chip
        tokens_chip = cell.batch * cell.seq / dp
        layers = cfg.n_layers + cfg.n_enc_layers
        # residual save+reload (x2 for an fp32 shadow) + block io
        traffic += layers * tokens_chip * cfg.d_model * 2 * 6
        return traffic
    args = rec["memory"]["argument_bytes"]
    if cell.kind == "prefill":
        tokens_chip = cell.batch * cell.seq / dp
        layers = cfg.n_layers + cfg.n_enc_layers
        return args + layers * tokens_chip * cfg.d_model * 2 * 4
    return args + rec["memory"]["output_bytes"]   # decode: read everything


def read_bytes(rec: dict) -> float:
    """A decode step's read-only bound: every argument read once (the
    weights and the whole cache), nothing written."""
    return float(rec["memory"]["argument_bytes"])


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0        # analytic achievable-minimum traffic
    memory_hlo_s: float = 0.0    # op counter's no-fusion bound
    collective_s: float = 0.0
    hlo_flops: float = 0.0
    model_flops_v: float = 0.0
    n_collectives: int = 0
    peak_mem_gib: float = 0.0
    fits_hbm: bool = True
    reason: str = ""

    @property
    def bottleneck(self) -> str:
        if self.status != "ok":
            return "-"
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_v / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable compute fraction: useful-FLOPs time over the max
        (dominating) term."""
        dom = max(self.compute_s, self.memory_s, self.collective_s)
        if dom == 0:
            return 0.0
        return (self.model_flops_v / PEAK_FLOPS) / dom


def analyze_record(rec: dict) -> RooflineRow:
    if rec.get("status") != "ok":
        return RooflineRow(arch=rec["arch"], shape=rec["shape"],
                           mesh=rec.get("mesh_name", "?"),
                           status=rec.get("status", "?"),
                           reason=rec.get("reason", rec.get("error", "")))
    cfg = get_config(rec["arch"])
    n_chips = rec["n_chips"]
    flops = rec["cost"]["flops_per_device"]
    nbytes = rec["cost"]["bytes_per_device"]
    cbytes = rec["collectives"]["total_bytes"]
    cops = rec["collectives"]["total_count"]
    mem = rec["memory"]
    peak = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] \
        - mem["alias_bytes"]
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec.get("mesh_name", "?"),
        status="ok",
        compute_s=flops / PEAK_FLOPS,
        memory_s=model_bytes(cfg, rec) / HBM_BW,
        memory_hlo_s=nbytes / HBM_BW,
        collective_s=cbytes / LINK_BW + cops * ICI_ALPHA,
        hlo_flops=flops,
        model_flops_v=model_flops(cfg, rec["shape"], n_chips),
        n_collectives=int(cops),
        peak_mem_gib=peak / 2**30,
        fits_hbm=peak <= HBM_BYTES,
    )


def load_rows(dryrun_dir: str, mesh: Optional[str] = "single") -> list:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        if os.path.basename(path) == "summary.json":
            continue
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh_name") != mesh:
            continue
        rows.append(analyze_record(rec))
    return rows


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL/counted flops | roofline frac | peak GiB | "
           "fits |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        if r.status != "ok":
            lines.append(f"| {r.arch} | {r.shape} | - | - | - | skipped | "
                         f"- | - | - | ({r.status}) |")
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.3e} | {r.memory_s:.3e}"
            f" | {r.collective_s:.3e} | {r.bottleneck} |"
            f" {r.useful_ratio:.2f} | {r.roofline_fraction:.3f} |"
            f" {r.peak_mem_gib:.1f} | {'y' if r.fits_hbm else 'NO'} |")
    return "\n".join(lines)
