"""Host milliseconds per build of a light outside a view: each root span
light (a relight, built before its view opens the span view), less the
time its sync.* spans block on the device (window A). What
host_issue_ms.serve does not see of a relit view. Nothing without the
program's spans (perfbench/spans.py), or where no light was built
outside a view."""
from perfbench import spans


def read(t):
    return spans.host_issue_ms(t, "light")
