"""D&C sub-table LUT GEMMs: the frozen 4-bit decode projections."""
