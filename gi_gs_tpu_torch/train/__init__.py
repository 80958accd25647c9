"""Phase-1 training of the port (losses, optimizer, densification, the
train step)."""
