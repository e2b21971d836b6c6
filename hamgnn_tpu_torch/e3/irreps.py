"""Irreducible-representation (irreps) algebra for O(3)-equivariant networks.

Counterpart of ``hamgnn_tpu/e3/irreps.py``: pure-Python metadata, no tensors.

Conventions (e3nn's):
  * an irrep is ``(l, p)`` with ``p in {+1, -1}`` printed as ``"2e"``/``"1o"``;
  * features are flat ``(..., irreps.dim)`` with each ``mul x ir`` chunk
    contiguous and multiplicity-major: ``[u0 m=-l..l, u1 m=-l..l, ...]``;
  * real spherical harmonics ordered ``m = -l..l`` (l=1 is (y, z, x)).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True, order=False)
class Irrep:
    """A single irreducible representation of O(3): angular momentum + parity."""

    l: int
    p: int

    def __post_init__(self):
        if self.l < 0:
            raise ValueError(f"l must be >= 0, got {self.l}")
        if self.p not in (1, -1):
            raise ValueError(f"p must be +/-1, got {self.p}")

    @classmethod
    def parse(cls, s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            return cls(int(s[0]), int(s[1]))
        s = s.strip()
        try:
            l = int(s[:-1])
            p = {"e": 1, "o": -1}[s[-1]]
        except (ValueError, KeyError, IndexError):
            raise ValueError(f"cannot parse irrep {s!r}")
        return cls(l, p)

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __iter__(self) -> Iterator[int]:
        yield self.l
        yield self.p

    def __lt__(self, other: "Irrep") -> bool:
        return (self.l, -self.p * (-1) ** self.l) < (other.l, -other.p * (-1) ** other.l)

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        """Selection rule: l1 x l2 -> |l1-l2|..l1+l2."""
        other = Irrep.parse(other)
        p = self.p * other.p
        return [Irrep(l, p) for l in range(abs(self.l - other.l), self.l + other.l + 1)]


@dataclasses.dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"

    def __iter__(self):
        yield self.mul
        yield self.ir


class Irreps(tuple):
    """A direct sum of multiplicities of irreps, e.g. ``Irreps("64x0e+32x1o")``."""

    def __new__(cls, irreps: Union[str, "Irreps", Sequence, None] = None):
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return super().__new__(cls, tuple(irreps))
        if isinstance(irreps, Irrep):
            return super().__new__(cls, (MulIrrep(1, irreps),))
        if isinstance(irreps, MulIrrep):
            return super().__new__(cls, (irreps,))
        if isinstance(irreps, str):
            out = []
            s = irreps.strip()
            if s:
                for term in s.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        out.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.parse(term)))
            return super().__new__(cls, tuple(out))
        out = []
        for item in irreps:
            if isinstance(item, MulIrrep):
                out.append(item)
            elif isinstance(item, Irrep):
                out.append(MulIrrep(1, item))
            else:
                mul, ir = item
                ir = Irrep(*ir) if isinstance(ir, tuple) else Irrep.parse(ir)
                out.append(MulIrrep(int(mul), ir))
        return super().__new__(cls, tuple(out))

    def __repr__(self) -> str:
        return "+".join(repr(mi) for mi in self) if len(self) else "Irreps()"

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __radd__(self, other) -> "Irreps":
        return Irreps(tuple(Irreps(other)) + tuple(self))

    def __mul__(self, n: int) -> "Irreps":
        return Irreps(tuple(self) * n)

    __rmul__ = __mul__

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if not self:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    def slices(self) -> List[slice]:
        out = []
        start = 0
        for mi in self:
            out.append(slice(start, start + mi.dim))
            start += mi.dim
        return out

    def simplify(self) -> "Irreps":
        out: List[MulIrrep] = []
        for mi in self:
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            elif mi.mul > 0:
                out.append(mi)
        return Irreps(out)

    def sort(self) -> Tuple["Irreps", Tuple[int, ...], Tuple[int, ...]]:
        """Sort by irrep.  Returns (sorted_irreps, p, inv) with
        ``p[old_index] = new_index`` (e3nn's ``Irreps.sort().p``)."""
        order = sorted(range(len(self)), key=lambda i: self[i].ir)
        inv = tuple(order)
        p = [0] * len(self)
        for new, old in enumerate(order):
            p[old] = new
        return Irreps([self[old] for old in order]), tuple(p), inv


def irreps2gate(irreps: Irreps):
    """Split irreps into (scalars, gates, gated) for the Gate nonlinearity:
    scalars keep all l==0 channels, each non-scalar channel gets one 0e gate."""
    irreps = Irreps(irreps)
    irreps_scalars = Irreps([mi for mi in irreps if mi.ir.l == 0]).simplify()
    irreps_gated = Irreps([mi for mi in irreps if mi.ir.l != 0]).simplify()
    if irreps_gated.dim > 0:
        irreps_gates = Irreps([(mi.mul, "0e") for mi in irreps_gated]).simplify()
    else:
        irreps_gates = Irreps()
    return irreps_scalars, irreps_gates, irreps_gated
