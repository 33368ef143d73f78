"""Storage engine formats: needles, volumes, needle maps, erasure coding."""
