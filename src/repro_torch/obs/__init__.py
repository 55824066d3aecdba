"""repro_torch.obs — the runtime observability plane (counterpart of
``repro.obs``; DESIGN.md §14).

Three zero-dependency instruments plus one dispatch introspection API:

    trace     span/event tracer, Chrome-trace/Perfetto export
    metrics   counters / gauges / log2 histograms, dict snapshot
    drift     live dispatch timings vs the cost model's calibration
    explain   the ranked dispatch table — every candidate with its
              accept/reject reason, without executing anything

``explain`` answers the question dispatch never had to: *why this
variant*.  It evaluates the same ranking and the same predicates
``registry.select`` uses, so the winner it reports is the variant
``dispatch`` would run.  It never measures: a variant's blocks are
measured only when its ``impl`` runs.
"""
from repro_torch.obs import drift, metrics, trace
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import TRACER

__all__ = ["trace", "metrics", "drift", "TRACER", "METRICS", "explain",
           "explain_str"]


def explain(op, *args, variant=None, **kwargs):
    """The ranked candidate table for one dispatch, without executing:
    one row per registered variant in selection order, each carrying
    ``selected`` and a ``reason`` (``selected`` / ``plane-unavailable`` /
    ``accepts-predicate`` / ``outranked-by-calibration`` / ``outranked``).
    Evaluated for these operands' device and the requested plane, exactly
    like ``dispatch``."""
    from repro_torch.core import registry
    return registry.REGISTRY.explain(op, *args, variant=variant, **kwargs)


def explain_str(rows) -> str:
    """Human-readable rendering of an :func:`explain` table."""
    if not rows:
        return "(no candidates)"
    head = f"{'#':>2} {'variant':<22} {'plane':<9} {'scope':<5} " \
           f"{'cost':>8} {'measured':>11}  reason"
    lines = [head, "-" * len(head)]
    for row in rows:
        meas = row.get("calibrated_seconds")
        lines.append(
            f"{row['rank']:>2} "
            f"{('* ' if row['selected'] else '  ') + row['variant']:<22} "
            f"{str(row['plane']):<9} {row['scope']:<5} "
            f"{row['cost']:>8.3g} "
            f"{(f'{meas:.3e}' if meas is not None else '-'):>11}  "
            f"{row['reason']}")
    return "\n".join(lines)
