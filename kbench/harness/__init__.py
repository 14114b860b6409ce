"""The benchmark's harness: specs, the closed loop, the trace's reduction,
the correctness check and the byte models."""
