"""Seconds a driver step in the preconditioner's rebuild
(``initialize``), by the fenced ``bench.rebuild`` span, over the
window's steps."""


def read(run):
    spans = run.span_seconds.get("bench.rebuild")
    if not spans or not run.units:
        return None
    return sum(spans) / run.units
