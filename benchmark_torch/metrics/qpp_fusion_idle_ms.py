"""qpp_fusion_idle_ms: device-idle ms per step while the host was inside
QPP or fusion: the trace's idle gaps whose label names one of those spans
as the innermost span open at the gap's midpoint (``qpp``, ``qpp_norm``,
``minmax``, ``fusion``, or a program sub-span ``qpp.*`` / ``fusion.*``).
A label is ``<span> > <op>``, ``<span>`` or ``<op>``; an op alone names no
span. Nothing where the trace holds no device work."""

SPANS = ("qpp", "qpp_norm", "minmax", "fusion")
PREFIXES = ("qpp.", "fusion.")


def in_layer(label: str) -> bool:
    """True where the gap's label names a QPP or fusion span."""
    part = label.split(" > ", 1)[0]
    return part in SPANS or part.startswith(PREFIXES)


def read(summary: dict):
    if summary["busy_s"] <= 0 or not summary["steps"]:
        return None
    idle = sum(s for label, s in summary["idle_gaps"].items() if in_layer(label))
    return idle * 1e3 / summary["steps"]
