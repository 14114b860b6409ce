"""Plain PyTorch references: the stencil product, the V-cycle and CG."""
