"""Device operators: the torch programs and the hand-written kernels."""
