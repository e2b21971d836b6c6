"""The benchmark's harness: the specification files, the traffic generator,
the seeded weights, the runs of a cell, the comparison that decides
``correct``, the work counts and the reading of the trace."""
