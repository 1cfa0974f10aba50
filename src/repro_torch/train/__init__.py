"""Step builders, the segment loop and the straggler watchdog of the port."""
