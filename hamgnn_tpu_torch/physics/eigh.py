"""Hermitian eigensolve and Cholesky factor of the band branch that give NaN
where JAX's give NaN: what a CUDA graph can record, or run between its
graphs.

``jnp.linalg.cholesky`` and ``jnp.linalg.eigh`` return NaN for a matrix
whose factorisation fails (an overlap S(k) that is not positive definite)
or that holds NaN; ``torch.linalg.cholesky`` and ``eigh`` raise there, and
to know that they must, they read the solver's ``info`` on the host after
every call, which waits for the card.  Here:

- ``cholesky`` is ``torch.linalg.cholesky_ex`` without the check, with the
  factor of each matrix whose ``info`` is not 0 set to NaN on the device
  (below the diagonal, as JAX's);
- ``hermitian_eigh`` solves each matrix that is finite, a stand-in with
  distinct eigenvalues in place of each that is not, and sets the
  eigenvalues and eigenvectors of the matrices that were not finite or
  whose solve failed to NaN.  The solve is ``torch.linalg.eigh``
  (``solve_eigh``); where it raises that a matrix did not converge, each
  matrix is solved alone and those that fail are marked.

No eigensolver of cuSOLVER can be captured in a CUDA graph (``Xsyevd``,
``XsyevBatched`` above 32 rows and ``heevj`` wait for the card inside the
call), so on the card the solve is handed to ``utils.cuda_graphs.host_step``:
a captured step runs it between two of its graphs, into buffers of the
capture.

Both share one backward, written in tensor ops (``eigh_backward``): torch's
own backward of ``eigh`` checks the phase invariance of a complex loss on
the host.  A stand-in's eigenvalues are distinct, so the backward through it
is finite, and the ``where`` that replaces its outputs by NaN passes it a
zero gradient.
"""

from __future__ import annotations

import torch

from ..utils.cuda_graphs import host_step

# eigensolves run on the card, counted on the host where they run: a
# captured step's replays run theirs between its graphs, and count them too
CARD_SOLVES = {"calls": 0}


def cholesky(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``S`` (..., n, n); where the
    factorisation fails, NaN on and below the diagonal and 0 above it, as
    ``jnp.linalg.cholesky``."""
    L, info = torch.linalg.cholesky_ex(S)
    lower = torch.ones(S.shape[-2:], dtype=torch.bool, device=S.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & lower, float("nan"))


def solve_eigh(A: torch.Tensor, w: torch.Tensor, V: torch.Tensor, info: torch.Tensor) -> None:
    """``torch.linalg.eigh`` of finite Hermitian matrices ``A`` (b, n, n)
    into ``w`` (b, n) and ``V`` (b, n, n); ``info`` (b,) 1 for each matrix
    that did not converge (its ``w`` and ``V`` left as they are), else 0.
    On the CPU LAPACK runs on one thread: MKL's threaded ``heevd`` is slower
    on the band branch's matrices, and its threads spin-wait, so that it
    slows down by orders of magnitude when other processes share the
    cores.  Runs in inference mode: a replay calls it outside the autograd
    ``Function`` that gave it its tensors, and they are inference tensors
    where the capture was an eval step's."""
    threads = torch.get_num_threads()
    if not A.is_cuda:
        torch.set_num_threads(1)
    try:
        with torch.inference_mode():
            _solve_eigh(A, w, V, info)
    finally:
        torch.set_num_threads(threads)


def _solve_eigh(A, w, V, info) -> None:
    info.zero_()
    try:
        torch.linalg.eigh(A, out=(w, V))
    except torch.linalg.LinAlgError:
        for i in range(A.shape[0]):
            try:
                torch.linalg.eigh(A[i], out=(w[i], V[i]))
            except torch.linalg.LinAlgError:
                info[i] = 1


def plain_hermitian_eigh(A: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns, info) of finite
    Hermitian matrices ``A`` (..., n, n), by ``solve_eigh``; on the card it
    is handed to ``host_step``, and counted in ``CARD_SOLVES``."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    work = A.reshape(-1, n, n)
    w = torch.empty(work.shape[:-1], dtype=A.real.dtype, device=A.device)
    V = torch.empty_like(work)
    info = torch.empty(work.shape[0], dtype=torch.int32, device=A.device)
    if A.is_cuda:
        def solve():
            CARD_SOLVES["calls"] += 1
            solve_eigh(work, w, V, info)

        host_step(solve)
    else:
        solve_eigh(work, w, V, info)
    return w.reshape(*batch, n), V.reshape(*batch, n, n), info.reshape(batch)


def eigh_backward(w: torch.Tensor, V: torch.Tensor, gw, gV) -> torch.Tensor:
    """dL/dA of A = V diag(w) V^H from dL/dw and dL/dV (either may be None):
    V (diag(gw) + P(V^H gV) / (w_j - w_i)) V^H with P the skew-Hermitian
    part off the diagonal, as torch's backward of ``linalg.eigh`` for a
    loss that does not depend on the eigenvectors' phases."""
    n = w.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=w.device)
    inner = torch.zeros_like(V)
    if gV is not None:
        VhgV = V.mH @ gV
        gap = w.unsqueeze(-2) - w.unsqueeze(-1)
        inner = torch.where(off, 0.5 * (VhgV - VhgV.mH) / torch.where(off, gap, 1.0), inner)
    if gw is not None:
        inner = inner + torch.diag_embed(gw.to(V.dtype))
    return V @ inner @ V.mH


class _Eigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        ctx.set_materialize_grads(False)
        w, V, info = plain_hermitian_eigh(A)
        ctx.mark_non_differentiable(info)
        ctx.save_for_backward(w, V)
        return w, V, info

    @staticmethod
    def backward(ctx, gw, gV, _ginfo):
        w, V = ctx.saved_tensors
        return eigh_backward(w, V, gw, gV)


def hermitian_eigh(A: torch.Tensor):
    """(eigenvalues ascending (..., n), eigenvectors as columns (..., n, n))
    of Hermitian matrices ``A`` (..., n, n); both NaN for a matrix that is
    not finite or whose solve fails, as ``jnp.linalg.eigh``."""
    n = A.shape[-1]
    finite = torch.isfinite(A).all(-1).all(-1)
    stand_in = torch.diag_embed(torch.arange(n, device=A.device).to(A.dtype))
    w, V, info = _Eigh.apply(torch.where(finite[..., None, None], A, stand_in))
    ok = finite & (info == 0)
    return (w.masked_fill(~ok[..., None], float("nan")),
            V.masked_fill(~ok[..., None, None], float("nan")))
