"""Milliseconds a preconditioner apply (the V-cycle), by the fenced
``bench.vcycle`` span, over the window's applies."""


def read(run):
    spans = run.span_seconds.get("bench.vcycle")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
