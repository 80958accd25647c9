"""Host milliseconds per training step inside the program's span step, less
the time its sync.* spans block on the device (window A). Nothing
without the program's spans (perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.host_issue_ms(t, "step")
