"""Numerics core of the port: bit-plane slicing and sliced integer GEMMs."""
