"""Device operations: paged updates, sketches and the hand-written kernels."""
