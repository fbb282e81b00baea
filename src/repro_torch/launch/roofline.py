"""Roofline models on an H100: the LM dry run's cells, and one fused-hop
launch (DESIGN.md §13).

    PYTHONPATH=src python -m repro_torch.launch.roofline --results launch_results

Port of the JAX package's ``launch/roofline.py``, both halves.

**The LM cells** (``launch/dryrun.py``'s records).  Per (arch × shape ×
mesh) cell, three per-step time bounds on one H100 SXM5 (NVIDIA H100 80GB
HBM3, 700 W; NVIDIA's data sheet, dense rates):

    compute    = dot_flops (per device)          / 989e12 FLOP/s (bf16 tensor cores)
    memory     = hbm_bytes (per device)          / 3.35e12 B/s
    collective = Σ ring-model traffic per device / the group's link

``dot_flops`` and ``hbm_bytes`` are rank 0's, counted from the ops the
cell dispatched (``launch/hlo_analysis.py``).  Collective traffic uses
ring algorithms, as the reference's: all-gather and all-to-all (k-1)/k ×
bytes, all-reduce 2(k-1)/k × bytes, reduce-scatter (k-1) × the result
shard, permute 1×.  **The link follows from the span of the group's
ranks**, laid out row-major, :data:`NODE_GPUS` to a node, not from the
group's size as in the reference (``k in (2, 32, 512)`` rode its DCN): a
group whose first and last rank share a node rides NVLink 4
(:data:`NVLINK_BW` a direction), any other InfiniBand NDR, one 400 Gb/s
port a GPU (:data:`IB_BW`).  On (data 16, model 16) a ``model`` group of
16 ranks spans 2 nodes and a ``data`` group 16, so both cross
InfiniBand; on (2, 2) every group shares a node.  A cell fits when its
argument and temp bytes are below :data:`HBM_BYTES` (the reference held
temp alone against a TPU's memory).  The ratio MODEL/HLO (``useful_ratio``) exposes
recompute, work every rank of a group repeats (heads that ``model`` does
not divide run whole) and dead FLOPs; MODEL_FLOPS (global, then ÷ chips):

    train    6·N_active·D + 3·attn_fwd      (D = tokens per step)
    prefill  2·N_active·D + attn_fwd
    decode   2·N_active·B + 4·L·nh·hd·S·B   (KV-cache attention reads)

**One fused-hop launch.**  The Hopper counterpart of the reference's
``fused_hop_vmem_bytes``/``fused_hop_cost``.  A TPU grid cell
holds its tiles in VMEM and streams the rest, so the reference admits
a tile configuration by its VMEM bytes and scores it by a two-term
roofline.  A launch of ``csrc/fused_hop.cu`` is admitted by the
launch's own limits instead (:func:`fused_hop_admissible`), and scored
(:func:`fused_hop_cost`) by the largest of three terms:

* **bytes**: the edge columns once; each child's gathered rows once
  where the part of the operand that the order of the blocks keeps live
  fits the 50 MB L2 (one column slab of it in slab-major order, all of
  it otherwise), from device memory per edge where it does not; the
  output once; all at :data:`HBM_BW`.
* **operations**: one multiply and one add (or add and min/max) per edge,
  output column and child, at :data:`PEAK_FLOPS`.
* **serial**: what a TPU grid lacks.  The walks fold a row's run of
  edges in turn, one lane per output column (``csrc/gathered_rows.cuh``,
  ``csrc/segmented_rows.cuh``), so a launch takes at least as long as
  its busiest walker: ``ceil(edges·slabs / min(num_rows·slabs,
  blocks·warps))`` edge steps of the warp walk, or, where the launch
  holds more warps than the card runs at once, the average over the
  card's warp slots; each step costs :data:`EDGE_S` (one warp, with its
  plan's edges in flight) plus :data:`SM_EDGE_S` for each warp active on
  its SM.

The two per-edge constants are fitted to ``tools/walk_sweep.py --cases
gather`` on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6): a few-row
hop gives :data:`EDGE_S` (few warps, so each edge waits for its step),
the main path's C1 hop gives :data:`SM_EDGE_S` (every warp slot busy).
Edges in flight bought nothing in either (the few-row hop took the same
time at 1, 4 and 8; C1 lost 12 % and 54 % to them), so the model never
prefers them.  The same figures as PERF.md §6's bounds give the rest.
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

HBM_BW = 3.35e12  # H100 SXM device memory, bytes/s
PEAK_FLOPS = 67e12  # H100 SXM FP32 without tensor cores, operations/s
BF16_PEAK_FLOPS = 989e12  # H100 SXM bf16 dense on the tensor cores, FLOP/s
NVLINK_BW = 450e9  # NVLink 4 within a node, bytes/s a direction
IB_BW = 400e9 / 8  # InfiniBand NDR across nodes, one 400 Gb/s port a GPU, bytes/s
NODE_GPUS = 8
HBM_BYTES = 80e9
CHIPS = {"single": 256, "multi": 512}
L2_BYTES = 50_000_000  # H100 SXM L2
SMS = 132
SM_WARPS = 64  # warps an SM holds at once
SM_BLOCKS = 32  # blocks an SM holds at once
WALK_BLOCKS_SM = 8  # segmented_rows.cuh: fused_hop's ops keep eight 256-thread blocks an SM
WARP_COLUMNS = 128  # gathered_rows.cuh: a warp covers 128 columns (4 a lane) per pass
WALK_WARPS = ops.WALK_THREADS // 32  # warps of a tile-walk block

#: seconds per edge step of one warp with 1, 4 or 8 edges' gathers in
#: flight, when few warps share an SM: the 32-row hop of PERF.md §6 at 16
#: rows and 4 warps a block (316,303 steps a warp; 81.44 / 82.17 / 81.47 ms)
EDGE_S = {1: 257.5e-9, 4: 259.8e-9, 8: 257.6e-9}
#: seconds each active warp of an SM adds to a warp edge step, by edges
#: in flight (the queue for the SM's memory pipe): C1's one-child sum hop,
#: k = 2, d = 4,500 at 16 rows, 4 warps and slabs of 128 (2,130.5 steps a
#: slot, 64 warps an SM; 2.3724 / 2.6661 / 3.6616 ms)
SM_EDGE_S = {1: 13.375e-9, 4: 15.49e-9, 8: 22.83e-9}


def fused_hop_admissible(plan) -> bool:
    """Whether the launch's own limits take ``plan`` (a
    :class:`ops.GatherPlan` or :class:`ops.WalkPlan`), in place of the
    reference's VMEM budget: the shared memory a block gets without
    opting in (the run bounds, two int32 a row of its tile), the blocks of
    one launch and, for the warp walk, no more warps than rows in a
    block.  ``ops.make_*_plan`` raise on the rest."""
    if plan.smem_bytes > ops.SMEM_LIMIT or plan.blocks > ops.MAX_BLOCKS:
        return False
    return not isinstance(plan, ops.GatherPlan) or plan.warps <= plan.rows_per_block


def _child_bytes(edges: int, rows: int, cols: int, live_cols: int) -> float:
    """Bytes of one child's gathers: its rows once where ``live_cols`` of
    them fit L2, one row piece per edge from device memory otherwise."""
    if rows * live_cols * 4 <= L2_BYTES:
        return 4.0 * rows * cols
    return 4.0 * edges * cols


def _edge_step_s(edges_in_flight: int, active_warps_per_sm: float) -> float:
    """One warp's edge step: its own latency, plus the queue that the
    SM's other active warps make."""
    return EDGE_S[edges_in_flight] + active_warps_per_sm * SM_EDGE_S[edges_in_flight]


def _gather_serial_s(edges: int, num_rows: int, plan) -> float:  # tile-math
    """The warp walk's busiest warp slot: its edge steps times their cost."""
    passes = -(-plan.slab // WARP_COLUMNS)
    warps = plan.blocks * plan.warps
    resident = SMS * min(SM_WARPS, SM_BLOCKS * plan.warps)
    walkers = min(num_rows * plan.slabs, warps)
    if walkers > resident:  # waves of warps: the card's slots share the work
        steps = edges * plan.slabs / resident
    else:
        steps = -(-(edges * plan.slabs) // walkers)
    active = min(walkers, resident) / SMS
    return steps * passes * _edge_step_s(plan.in_flight, active)


def _walk_serial_s(edges: int, num_rows: int, d: int, plan) -> float:  # tile-math
    """The tile walk's busiest thread: a block's threads share its (row,
    column) items, each folding one row's run of edges in turn (the
    narrow walk: one thread a run, all its columns); blocks beyond what
    the card holds at once run in waves.  fused_hop's one-edge loop is
    costed as the warp walk with one edge in flight."""
    per_row = max(1.0, edges / num_rows)
    threads = ops.WALK_THREADS
    if plan.narrow:
        runs = min(plan.rows_per_tile, edges * plan.rows_per_tile / num_rows)
        busiest = -(-max(1, math.ceil(runs)) // threads) * per_row * d
    else:
        busiest = -(-(plan.rows_per_tile * plan.slab) // threads) * per_row
    resident = SMS * WALK_BLOCKS_SM
    waves = max(1.0, plan.blocks / resident)
    active = min(plan.blocks, resident) * WALK_WARPS / SMS
    return waves * busiest * _edge_step_s(1, active)


def fused_hop_cost(  # tile-math
    edges: int,
    child_rows: tuple[int, ...],
    child_widths: tuple[int, ...],
    num_segments: int,
    k: int,
    plan,
) -> dict[str, float]:
    """Modelled seconds of one ``fused_hop`` launch of ``edges`` edges
    into ``(num_segments, Π child_widths · k)`` gathering from children
    of ``child_rows`` rows, at ``plan`` (made by ``ops.make_gather_plan``
    or ``ops.make_walk_plan`` for that output): ``flops``, ``hbm_bytes``,
    ``serial_s``, ``seconds`` (the largest of the three times) and
    ``bound`` (which one it is: "bytes", "operations" or "serial")."""
    nchild = len(child_rows)
    d = math.prod(child_widths) * k
    hbm = 4.0 * edges * (2 + k + 2 * nchild)  # int64 keys and indices, f32 weights
    if isinstance(plan, ops.GatherPlan):
        live = plan.slab if plan.slab_major else d
        hbm += sum(_child_bytes(edges, r, d, live) for r in child_rows)
        serial = _gather_serial_s(edges, num_segments, plan)
    else:
        hbm += sum(
            _child_bytes(edges, r, w * k, w * k) for r, w in zip(child_rows, child_widths)
        )
        serial = _walk_serial_s(edges, num_segments, d, plan)
    hbm += 4.0 * num_segments * d
    flops = float(edges) * d * (nchild + 1)
    times = {"bytes": hbm / HBM_BW, "operations": flops / PEAK_FLOPS, "serial": serial}
    bound = max(times, key=times.get)
    return {"flops": flops, "hbm_bytes": hbm, "serial_s": serial,
            "seconds": times[bound], "bound": bound}


# ---------------------------------------------------------------- the LM cells


def ring_traffic(kind: str, nbytes: float, k: int) -> float:
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2 * (k - 1) / k * nbytes
    if kind == "reduce-scatter":
        return (k - 1) * nbytes  # nbytes = result shard
    if kind == "collective-permute":
        return nbytes
    return (k - 1) / k * nbytes  # all-gather / all-to-all


def link_bw(ranks: list[int]) -> float:
    """The link a group whose first and last rank are ``ranks`` rides."""
    first, last = ranks
    return NVLINK_BW if first // NODE_GPUS == last // NODE_GPUS else IB_BW


def collective_seconds(colls: list[dict]) -> float:
    """Σ ring traffic / link over ``colls`` (each with ``kind``, ``bytes``,
    ``group`` and the member span ``ranks``)."""
    return sum(ring_traffic(c["kind"], c["bytes"], max(int(c["group"]), 1))
               / link_bw(c["ranks"]) for c in colls)


def model_flops_of(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS (global) of ``cfg`` at ``shape`` (module docstring)."""
    N = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    # useful causal attention flops per layer per sequence (fwd):
    # qk + av over the causal half = 2 * (S^2/2) * nh * hd * 2 = 2 S^2 nh hd
    n_attn_layers = 0
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn_layers = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // max(cfg.shared_period, 1)
    elif cfg.family == "audio":
        n_attn_layers = cfg.n_layers + cfg.enc_layers  # self (+cross ~small)
    attn_fwd = 2.0 * S * S * cfg.n_heads * cfg.hd * n_attn_layers * B
    if shape.kind == "train":
        return 6.0 * N * B * S + 3.0 * attn_fwd
    if shape.kind == "prefill":
        return 2.0 * N * B * S + attn_fwd
    # decode: one token over a length-S cache
    flops = 2.0 * N * B
    flops += 4.0 * n_attn_layers * cfg.n_heads * cfg.hd * S * B
    return flops


def model_flops(arch: str, shape_name: str) -> float:
    return model_flops_of(get_config(arch), SHAPES[shape_name])


def load_cells(out_dir: str) -> list[dict]:
    cells = []
    for fname in sorted(os.listdir(out_dir)):
        if fname.endswith(".json"):
            with open(os.path.join(out_dir, fname)) as f:
                cells.append(json.load(f))
    return cells


def analyze_cell(rec: dict) -> dict | None:
    """The three bounds of an ``ok`` record (module docstring), its
    dominant term, MODEL/HLO and the compute share of the bound; None for
    a record that is not ``ok``.  Chips: the record's mesh, MODEL_FLOPS:
    the record's own (its config and shape)."""
    if rec.get("status") != "ok":
        return None
    chips = math.prod(rec["mesh_shape"])
    compute_t = rec["dot_flops"] / BF16_PEAK_FLOPS
    memory_t = rec["hbm_bytes"] / HBM_BW
    coll_t = collective_seconds(rec["collectives_detail"])
    mf = rec["model_flops"] / chips
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **rec,
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "useful_ratio": mf / rec["dot_flops"] if rec["dot_flops"] else 0.0,
        "roofline_fraction": compute_t / bound if bound else 0.0,
    }


def markdown_table(cells: list[dict]) -> str:
    rows = [
        "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| bottleneck | MODEL/HLO | roofline frac | HBM fit |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in cells:
        if rec.get("status") == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | — | — | — | "
                f"skipped | — | — | {rec['reason']} |"
            )
            continue
        a = analyze_cell(rec)
        if a is None:
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | — | — | — | "
                f"ERROR | — | — | {rec.get('error','?')[:60]} |"
            )
            continue
        mem = rec["memory"]
        held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        fit = f"{held/2**30:.1f} GiB {'✓' if held < HBM_BYTES else '✗ OOM'}"
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['compute_s']*1e3:.2f} | {a['memory_s']*1e3:.2f} "
            f"| {a['collective_s']*1e3:.2f} | {a['dominant']} "
            f"| {a['useful_ratio']:.2f} | {a['roofline_fraction']:.2f} | {fit} |"
        )
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="launch_results")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    cells = load_cells(args.results)
    print(markdown_table(cells))
    if args.json_out:
        out = [analyze_cell(c) or c for c in cells]
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
