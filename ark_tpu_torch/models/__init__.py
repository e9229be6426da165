"""The Mesmer PanopticNet as torch modules."""
