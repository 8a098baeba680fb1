"""Client sampling and the simulation engines."""
