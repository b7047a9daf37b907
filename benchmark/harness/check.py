"""The comparison that decides ``correct``: the program's first three
training steps, as the timed path ran them, against the reference's
three steps from the same weights on the same draws.

The numbers (each a relative gap, 0 where the two agree):

* ``loss``: over the three steps, the largest gap of the program's total
  loss from the reference's, over the reference's;
* ``<term>`` for each loss term a limit names (``rgb_loss``,
  ``eikonal_loss``, ``line_loss``, ``j3d_loss``, ``j2d_loss``): the same
  for that term;
* ``grad``: the first gradient as the optimiser got it (the first
  moment after one step over 1 - b1), by the worst leaf: the gap of the
  program's norm of the leaf from the reference's, over the larger of
  the reference's norm of that leaf and its median leaf's;
* ``change``: the parameters' change after three steps, by the worst
  leaf the same way, over the leaves whose first reference gradient is at
  least a thousandth of the median leaf's (a leaf below that moves under
  Adam by round-off alone);
* ``loss1``, ``grad_median``, ``change_median``: the first step's loss
  alone, and the median leaf's gaps;
* ``junctions``: the junction stage's decisions checked by themselves
  (``junction_mismatches``), a count;
* ``proposals``: the matched local junctions checked by themselves
  (``proposal_gap``): DBSCAN's cluster means or the raw endpoints, the
  gather by the assignment and the projection;
* ``depths``, ``k1``, ``field_*``: the first step's sampler, proposal SDF
  and field pass checked by themselves (``stage_numbers``).

The sampler and the junction stage decide discretely (the sampler's
refinements, DBSCAN's clusters, the assignments, the gate), and a bf16
rounding flips a near-tied decision: a sample moves by a grid step, the
junction terms differ by a whole pair. So the reference follows the
program's depths and decisions (``program.recording`` gives them), and
those stages are checked on their own inputs: the decisions exactly.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

B1 = 0.9
TERMS = ("rgb_loss", "eikonal_loss", "line_loss", "j3d_loss", "j2d_loss")
# below this share of the median leaf's first gradient a leaf's change is
# round-off
STILL = 1e-3


def _finite(x: float) -> float:
    """A gap that is not a number reads infinite, so it fails any limit."""
    return x if math.isfinite(x) else float("inf")


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return _finite(abs(a - b) / abs(b)) if b != 0 else float("inf")


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in leaves)
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med)) if max(ref[k], med) > 0 else float("inf")
            for k in leaves}


def compare(prog_losses, prog_moment1, prog_params3, ref_losses, ref_grads1, ref_params3, weights0) -> dict:
    """Every number above, and the leaf each worst-leaf number came from."""
    out = {"loss": max(_rel(p["loss"], r["loss"]) for p, r in zip(prog_losses, ref_losses)),
           "loss1": _rel(prog_losses[0]["loss"], ref_losses[0]["loss"])}
    for t in TERMS:
        out[t] = max(_rel(p[t], r[t]) for p, r in zip(prog_losses, ref_losses))
    g_ref = _norms(ref_grads1)
    g_prog = _norms({k: m / (1.0 - B1) for k, m in prog_moment1.items()})
    gaps = _leaf_gaps(g_prog, g_ref, list(g_ref))
    out["grad_leaf"] = max(gaps, key=gaps.get)
    out["grad"], out["grad_median"] = gaps[out["grad_leaf"]], statistics.median(gaps.values())
    med_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL * med_g]
    d_ref = _norms({k: ref_params3[k] - weights0[k] for k in moving})
    d_prog = _norms({k: prog_params3[k] - weights0[k] for k in moving})
    gaps = _leaf_gaps(d_prog, d_ref, moving)
    out["change_leaf"] = max(gaps, key=gaps.get)
    out["change"], out["change_median"] = gaps[out["change_leaf"]], statistics.median(gaps.values())
    out["still_leaves"] = sorted(set(g_ref) - set(moving))
    return out


STAGES = ("depths", "k1", "field_sdf", "field_grad", "field_rgb", "field_lines")


def unfollowable() -> dict:
    """The numbers of a run the reference cannot follow: all infinite."""
    inf = float("inf")
    return {k: inf for k in ("loss", "loss1", "grad", "grad_median", "change", "change_median", "junctions",
                             "proposals") + TERMS + STAGES}


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1).to(a.device)
    return _finite(float(torch.linalg.norm(a - b) / torch.linalg.norm(b)))


@torch.no_grad()
def stage_numbers(records, stages: dict, weights, config: dict, device) -> dict:
    """The first step's stages checked by themselves, each by the
    reference on the program's own inputs to it:

    * ``depths``: the mean gap of the program's sample depths from the
      reference's own sampler's on the same rays and draws, over the far
      bound;
    * ``k1``: the proposal SDF at every point K1 evaluated, as the
      relative norm of the gap from the reference's;
    * ``field_sdf``, ``field_grad``, ``field_rgb``, ``field_lines``: the
      field pass at the points it ran on, the relative norms of the gaps
      of its SDF, SDF gradient, colour and attraction offsets. (The
      gradient jumps to the bounding sphere's where the clamp's branch
      flips under bf16, so ``field_grad`` is read, not held: the heads'
      outputs, which take the gradient, are.)

    A number is left out where the run did not record the stage (a CPU
    run launches no kernel)."""
    from reference import neat_ref

    rcfg = neat_ref.RefConfig.from_file(config)
    first = records[0]
    out = {}
    if "own_z" in stages:
        z = first["z"].to(device)
        out["depths"] = _finite(float(torch.mean(torch.abs(z - stages["own_z"]))) / (2.0 * rcfg.bound_sphere))
    if first.get("k1"):
        pts = torch.cat([p for p, _ in first["k1"]]).to(device)
        sdf = torch.cat([v.reshape(-1) for _, v in first["k1"]])
        out["k1"] = _rel_norm(sdf, neat_ref.sdf_values(weights, rcfg, "f32", pts))
    if first.get("field"):
        x, d, sdf, grad, rgb, lines = (t.to(device) for t in first["field"])
        r_sdf, r_grad, r_rgb, r_lines = neat_ref.field_pass(weights, rcfg, "f32", x, d)
        out["field_sdf"] = _rel_norm(sdf, r_sdf)
        out["field_grad"] = _rel_norm(grad, r_grad)
        out["field_rgb"] = _rel_norm(rgb, r_rgb)
        out["field_lines"] = _rel_norm(lines.reshape(-1, 2, 3) - x[:, None], r_lines - x[:, None])
    return out


def junction_mismatches(records, config: dict, device) -> int:
    """The junction stage checked by itself, on the program's own inputs to
    it: the rows where the reference's DBSCAN of the program's endpoints
    keeps another cluster than the program did, where the reference's
    auction on the program's cost and masks assigns otherwise, and where
    the gate on the program's assigned costs keeps otherwise; over both
    assignments and every followed step. 0 where all agree."""
    from reference import neat_ref

    use_median = config["model"]["use_median"]
    n = 0
    for r in records:
        r = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in r.items()}
        if "points" in r:
            _, valid = neat_ref.cluster_means(r["points"], *neat_ref.dbscan_labels(r["points"]))
            n += int((valid != r["dbscan_valid"]).sum())
        cols1 = r["cols1"] if r["cols1"] is not None else torch.ones(r["cost1"].shape[1], dtype=torch.bool,
                                                                     device=device)
        for cost, rows, cols, col, valid in ((r["cost1"], r["rows1"], cols1, r["col1"], r["valid1"]),
                                             (r["cost2"], r["keep"], None, r["col2"], r["valid2"])):
            if cols is None:
                cols = torch.ones(cost.shape[1], dtype=torch.bool, device=device)
            c, v = neat_ref.auction(cost, rows.bool(), cols.bool())
            n += int((v != valid).sum()) + int(((c != col.long()) & v & valid).sum())
        assigned = torch.gather(r["cost1"], 1, r["col1"].long()[:, None])[:, 0]
        gate = neat_ref._masked_median(assigned, r["valid1"]) if use_median else 10.0
        n += int(((r["valid1"] & (assigned < gate)) != r["keep"]).sum())
    return n


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest entry's gap of ``a`` from ``b`` over ``b``'s largest
    magnitude: one row astray shows whole."""
    a, b = a.double().reshape(-1), b.double().reshape(-1).to(a.device)
    gap = float(torch.max(torch.abs(a - b))) if b.numel() else 0.0
    return 0.0 if gap == 0.0 else _finite(gap / float(torch.max(torch.abs(b))))


def proposal_gap(records, ref_records) -> float:
    """The junction proposals checked by themselves, by the reference of a
    run that followed ``records`` (``ref_records``), the largest
    ``_max_gap`` over every step of:

    * the matched local junctions in 3D against those the reference works
      out from the program's endpoints, DBSCAN's labels of them and the
      first assignment: DBSCAN's means (or the raw endpoints) and the
      gather;
    * the calibrated projection of the program's own matched junctions,
      and the first assignment's cost of its own proposals: the
      projections.

    Each is float32 arithmetic on the same inputs, so a sound run reads
    round-off. The projections start from the program's 3D values, not the
    reference's: a point near the camera's plane turns a round-off in a
    mean into a large gap in its projection."""
    return max(max(_max_gap(r["j3d_local"], q["j3d_local"]),
                   _max_gap(r["j2d_local_calib"], q["j2d_calib_of_followed"]),
                   _max_gap(r["cost1"], q["cost1_of_followed"]))
               for r, q in zip(records, ref_records))


def judge(numbers: dict, limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the limits name, with its limit; None where the run
    could not read it (a stage it did not record)."""
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}


def holds(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
