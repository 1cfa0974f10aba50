"""Step builders of the port (serving steps only in this slice)."""
