"""Roofline terms per (arch x shape) from the dry run's own counts
(``benchmarks/roofline.py``), on NVIDIA H100 SXM constants.

Three terms, in seconds per step of one agent rank, each the rank's
count from the record ``python -m repro_torch.launch.dryrun --out DIR``
wrote, over the card's published peak:

  compute    = flops_per_rank / 989e12            (dense bf16 tensor cores)
  memory     = bytes_accessed_per_rank / 3.35e12  (HBM3)
  collective = bytes this rank sends / 450e9      (NVLink 4, one direction)

The constants are NVIDIA's H100 SXM data sheet's (dense rates without
sparsity, at the full 700 W power limit).  ``flops_per_rank`` is
``torch.utils.flop_counter``'s count of the traced step,
``bytes_accessed_per_rank`` every operator's inputs and outputs (eager
PyTorch moves them unfused), the sent bytes ``core.sharded.TRAFFIC``'s
over the step's collectives.  The link rate is a card's NVLink: the
port's Mode B on ONE card runs its ranks over gloo, which moved 0.3-0.7
GB/s a rank there, so the collective term is what a rank would pay with
a card of its own, not what one card measured.

``model_flops`` is the reference's chip-independent count (6 N_active
tokens for training, 2 N_active tokens to serve; a decode step is one
token for every sequence); its share of the rank's counted flops is the
useful ratio.  ``fits`` holds the record's live peak (arguments and every
operator's new storage until it is freed) to one card's 80 GB.  The
table goes to experiments/torch/roofline.md.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

from repro_torch import configs
from repro_torch.launch.dryrun import CARD_BYTES

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 (data sheet)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
LINK_BYTES_PER_S = 450e9     # H100 SXM NVLink 4: 900 GB/s, 450 each way
DRYRUN_DIR = os.path.join("experiments", "dryrun_torch")
OUT_PATH = os.path.join("experiments", "torch", "roofline.md")
MESH = "16"                  # the dry run's default: 16 agent ranks

NOTES = {
    "compute": "tensor-core-bound: more tokens per card, fp8",
    "memory": "HBM-bound: fuse what eager PyTorch moves operator by "
              "operator, bf16 gradients",
    "collective": "link-bound: rs_mm instead of gather_mm, overlap the "
                  "aggregation with backward, hierarchical aggregation",
}


@dataclasses.dataclass(frozen=True)
class Terms:
    compute: float
    memory: float
    collective: float
    model_flops: float          # 6*N_active*D (train) / 2*N_active*B (serve)
    counted_flops: int          # the dry run's flops_per_rank
    ranks: int
    live_peak_bytes: int
    dominant: str

    @property
    def total(self) -> float:
        return max(self.compute, self.memory, self.collective)

    @property
    def fits(self) -> bool:
        return self.live_peak_bytes <= CARD_BYTES

    @property
    def useful_ratio(self) -> float:
        """The rank's share of the model flops over its counted flops."""
        return self.model_flops / self.ranks / max(self.counted_flops, 1)

    @property
    def note(self) -> str:
        return NOTES[self.dominant]


def model_flops(arch_id: str, shape_name: str) -> float:
    """The reference's model flops of one step of the pair (all ranks)."""
    arch = configs.load_arch(arch_id)
    shape = configs.INPUT_SHAPES[shape_name]
    m = configs.model_for_shape(arch.model, shape)
    gb, s = shape.global_batch, shape.seq_len
    return (6 if shape.kind == "train" else 2) * m.active_param_count() \
        * (gb * s if shape.kind != "decode" else gb)


def terms(rec: dict) -> Terms:
    """The roofline terms of one dry-run record."""
    compute = rec["flops_per_rank"] / PEAK_BF16_FLOPS
    memory = rec["bytes_accessed_per_rank"] / HBM_BYTES_PER_S
    sent = sum(c["bytes"] for c in rec["collectives"].values())
    collective = sent / LINK_BYTES_PER_S
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])[0]
    return Terms(compute=compute, memory=memory, collective=collective,
                 model_flops=model_flops(rec["arch"], rec["shape"]),
                 counted_flops=rec["flops_per_rank"], ranks=rec["ranks"],
                 live_peak_bytes=rec["memory"]["live_peak_bytes"],
                 dominant=dom)


def load_dryrun(out_dir: str = DRYRUN_DIR) -> dict:
    recs = {}
    for path in glob.glob(os.path.join(out_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"],
              r.get("aggregation") or "-")] = r
    return recs


def table(out_dir: str = DRYRUN_DIR, mesh: str = MESH) -> list[tuple]:
    """(name, total us, dominant, Terms, record) for every traced pair of
    ``mesh``, in the matrix's order."""
    recs = load_dryrun(out_dir)
    rows = []
    for arch in configs.ARCH_IDS:
        for shape in configs.INPUT_SHAPES:
            key = next((k for k in recs if k[:3] == (arch, shape, mesh)), None)
            if key is None:
                continue
            t = terms(recs[key])
            rows.append((f"roofline/{arch}/{shape}/{mesh}", t.total * 1e6,
                         t.dominant, t, recs[key]))
    return rows


def markdown(out_path: str = OUT_PATH, out_dir: str = DRYRUN_DIR,
             mesh: str = MESH) -> None:
    rows = table(out_dir, mesh)
    traced = {tuple(name.split("/")[1:3]) for name, *_ in rows}
    lines = [
        f"# Roofline ({mesh} agent ranks, H100 SXM constants, per rank)",
        "",
        "| arch | shape | compute s | memory s | collective s | dominant |"
        " MODEL_FLOPS | counted flops/rank | useful-ratio | live peak GB |"
        " fits 80 GB | next move |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, _, dom, t, _rec in rows:
        _, arch, shape, _ = name.split("/")
        lines.append(
            f"| {arch} | {shape} | {t.compute:.3e} | {t.memory:.3e} |"
            f" {t.collective:.3e} | **{dom}** | {t.model_flops:.2e} |"
            f" {t.counted_flops:.2e} | {t.useful_ratio:.2f}x |"
            f" {t.live_peak_bytes / 1e9:.2f} | {'Y' if t.fits else 'N'} |"
            f" {t.note} |")
    missing = [f"{a}/{s}" for a in configs.ARCH_IDS
               for s in configs.INPUT_SHAPES if (a, s) not in traced]
    if missing:
        lines += ["", f"Not traced ({len(missing)}): " + ", ".join(missing)]
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(out_dir: str = DRYRUN_DIR, out_path: str = OUT_PATH) -> list[tuple]:
    out = [(name, us, f"dom={dom}")
           for name, us, dom, _, _ in table(out_dir)]
    markdown(out_path, out_dir)
    return out


if __name__ == "__main__":
    for name, us, derived in main():
        print(f"{name},{us:.2f},{derived}")
