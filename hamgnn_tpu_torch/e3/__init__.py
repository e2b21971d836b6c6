"""Equivariant building blocks (irreps algebra, CG tables, packed TP, layers)."""
