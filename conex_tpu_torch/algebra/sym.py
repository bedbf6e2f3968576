"""Dense symmetric-matrix helpers: exponentials and eigenvalue estimates.

Twin of ``conex_tpu/algebra/sym.py``: the Taylor exponential of the
geodesic step, the matmul-only extreme-eigenvalue estimators of the PSD and
Hermitian cones (the cold squaring estimator and the warm power
iteration), and the reference's Pade exponential and asymmetric Lanczos,
which the solve does not call.  Everything but the Lanczos broadcasts over
leading batch axes.

The float32 stages on float64 inputs are kept exactly as the JAX package
has them (eigenvector estimates in float32, Rayleigh quotients in the
input dtype): the two packages agree only if they round at the same
places.  The matrix products are plain ``torch.matmul``.  On a CUDA card
the warm estimator replays a CUDA graph captured from those same calls.
"""

from __future__ import annotations

import collections
import threading

import torch

from ..utils.profiling import counters


def expm_pade(A: torch.Tensor) -> torch.Tensor:
    """Pade(3,3)-style rational approximation of exp(A).

    reference: ComputeWeightedPowers + ExponentialMapPadeApproximation
    (exponential_map_pade.cc:10-32): with b = [120, 60, 12, 1],
    U = A (b3 A^2 + b1 I), V = b2 A^2 + b0 I, exp(A) ~ (V - U)^{-1}(V + U).
    Batched over leading axes.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A2 = A @ A
    U = A @ (A2 + 60.0 * eye)
    V = 12.0 * A2 + 120.0 * eye
    return torch.linalg.solve(V - U, V + U)


def expm_taylor(A: torch.Tensor, degree: int = 8, squarings: int = 3):
    """exp(A) via degree-``degree`` Taylor of exp(A / 2^s) + s squarings.

    The geodesic step's argument satisfies ||step * d|| <= sqrt(2) by the
    step-size rule (cone_program.cc:423-426), giving ~1e-12 accuracy at the
    defaults.  Batched over leading axes.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    X = A / (2.0 ** squarings)
    # Horner evaluation of sum X^k / k!.
    Y = eye + X / degree
    for k in range(degree - 1, 0, -1):
        Y = eye + (X @ Y) / k
    for _ in range(squarings):
        Y = Y @ Y
    return Y


def _pair_ip(V, U):
    """<V, U> = V[:, 0] . U[:, 1]: the two-column polynomial inner product.

    reference: inner_product (approximate_eigenvalues.cc:173-176).
    """
    return torch.dot(V[:, 0], U[:, 1])


def asymmetric_lanczos(WS, W, r, num_iter: int):
    """Eigenvalue estimates of WS (similar to symmetric W^{1/2} S W^{1/2}),
    for one (n, n) matrix.

    reference: AsymmetricLanczos (approximate_eigenvalues.cc:178-239).
    Tracks V = [p(WS) W r, p(WS)^T r] and builds the Jacobi (tridiagonal)
    matrix of the induced inner product; returns its eigenvalues,
    ascending.  The reference breaks when beta^2 < 1e-6; as in the JAX
    package the loop runs its full length under a mask instead: once
    inactive, it repeats alpha_0 on the diagonal (a Ritz value inside the
    converged spectrum interval) with zero off-diagonals, which leaves the
    extreme eigenvalues those of the truncated matrix.
    """
    V = torch.stack([W @ r, r], dim=1)
    V = V / torch.sqrt(_pair_ip(V, V))
    U = torch.stack([WS @ V[:, 0], WS.T @ V[:, 1]], dim=1)
    alpha0 = _pair_ip(V, U)
    U = U - alpha0 * V
    if num_iter == 1:
        return alpha0[None]

    Vprev = V
    active = torch.ones((), dtype=torch.bool, device=WS.device)
    alphas, betas = [alpha0], []
    for _ in range(num_iter - 1):
        beta_sq = _pair_ip(U, U)
        go = active & (beta_sq >= 1e-6)
        beta = torch.sqrt(torch.clamp(beta_sq, min=1e-300))
        V_new = U / beta
        U_new = torch.stack([WS @ V_new[:, 0], WS.T @ V_new[:, 1]], dim=1)
        alpha = _pair_ip(V_new, U_new)
        U_new = U_new - alpha * V_new - beta * V
        V, Vprev, U = (torch.where(go, V_new, V), torch.where(go, V, Vprev),
                       torch.where(go, U_new, U))
        alphas.append(torch.where(go, alpha, alpha0))
        betas.append(torch.where(go, beta, torch.zeros_like(beta)))
        active = go
    # The dense tridiagonal matrix: num_iter is the Lanczos depth, small.
    Tri = (torch.diag(torch.stack(alphas)) + torch.diag(torch.stack(betas), 1)
           + torch.diag(torch.stack(betas), -1))
    return torch.linalg.eigvalsh(Tri)


def approximate_eigenvalues(WS, W, r, num_iter: int):
    """Dispatcher (reference approximate_eigenvalues.cc:241-256): n = 1
    inputs are returned unchanged; otherwise asymmetric Lanczos."""
    if WS.shape[0] == 1:
        return WS[0]
    return asymmetric_lanczos(WS, W, r, num_iter)


def _fro(X):
    return torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True))


def _dominant_rayleigh_vec(B, num_squarings: int):
    """(lam_max, u, v) of B (real positive spectrum) via normalized repeated
    squaring + a two-sided Rayleigh quotient on the dominant left/right
    eigenvector estimates.

    On f64 inputs the squaring passes run in f32 (eigenvector estimates
    only: the Rayleigh quotient is second-order accurate in the
    eigenvector error) while the quotient itself uses the f64 matrix."""
    in_dtype = B.dtype
    Bq = B.float() if in_dtype == torch.float64 else B

    X = Bq / torch.clamp(_fro(Bq), min=1e-30)
    for _ in range(num_squarings):
        X = X @ X
        X = X / torch.clamp(_fro(X), min=1e-30)
    # Columns of X -> dominant right eigenvector; rows -> left eigenvector.
    # torch.argmax, like jnp.argmax, returns the first of tied maxima.
    j = torch.argmax(torch.sum(X * X, dim=-2), dim=-1)
    v = torch.take_along_dim(X, j[..., None, None], dim=-1)[..., 0]
    i = torch.argmax(torch.sum(X * X, dim=-1), dim=-1)
    u = torch.take_along_dim(X, i[..., None, None], dim=-2)[..., 0, :]
    u = u.to(in_dtype)
    v = v.to(in_dtype)
    Bv = (B @ v[..., None])[..., 0]
    uv = torch.sum(u * v, dim=-1)
    vv = torch.sum(v * v, dim=-1)
    two_sided = torch.sum(u * Bv, dim=-1) / uv
    one_sided = torch.sum(v * Bv, dim=-1) / vv
    # Two-sided RQ is second-order accurate but needs u.v bounded away
    # from 0; fall back to the one-sided quotient otherwise.
    lam = torch.where(
        torch.abs(uv) > 1e-6 * torch.sqrt(vv) * torch.linalg.vector_norm(u, dim=-1),
        two_sided,
        one_sided,
    )
    return torch.where(torch.isfinite(lam), lam, 0.0), u, v


def extreme_eigenvalues_seeded(M, num_squarings: int = 9):
    """(lam_lo, lam_hi, seeds, lam) of a matrix with real spectrum, cold.

    Shift by sigma >= rho(M) so that each extreme becomes dominant, then
    repeated squaring.  The shift comes from a cheap squaring pass on
    M @ M (in f32 on f64 inputs: it needs only a few digits).  Also returns
    the eigenvector estimates that seed extreme_eigenvalues_warm.
    """
    fro = torch.sqrt(torch.sum(M * M, dim=(-2, -1)))[..., None, None] + 1e-30
    Mq = (M / fro).float() if M.dtype == torch.float64 else M / fro
    rho2 = _dominant_rayleigh_vec(Mq @ Mq, 6)[0].to(M.dtype)
    rho = torch.sqrt(torch.clamp(rho2, min=0.0))[..., None, None] * fro
    # A squaring-pass Rayleigh quotient on a positive spectrum lies inside
    # the spectrum interval, so rho is a slight under-estimate; the 1.05
    # margin keeps sigma >= rho(M).  Fall back to Frobenius if degenerate.
    sigma = torch.where(
        torch.isfinite(rho) & (rho > 1e-3 * fro), 1.05 * rho, fro
    )
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    hi_s, uhi, vhi = _dominant_rayleigh_vec(M + sigma * eye, num_squarings)
    lo_s, ulo, vlo = _dominant_rayleigh_vec(sigma * eye - M, num_squarings)
    sig = sigma[..., 0, 0]
    lam_lo, lam_hi = sig - lo_s, hi_s - sig
    lam = torch.stack([lam_lo, lam_hi], dim=-1)
    return lam_lo, lam_hi, (vhi, uhi, vlo, ulo), lam


def extreme_eigenvalues(M, num_squarings: int = 9):
    """(lam_min, lam_max) of a matrix with real spectrum (similar to a
    symmetric matrix, such as WS = W S with W PSD), cold: the estimates of
    extreme_eigenvalues_seeded without the seeds.

    Replaces the reference's Lanczos + tridiagonal-eigenvalue pipeline
    (psd_constraint.cc:63-77) for the spectrum extremes.  The shift comes
    from a squaring pass on M @ M in f32 (on f64 inputs) and is tight, 1.05
    rho(M), which keeps clustered spectra accurate.
    """
    lam_lo, lam_hi, _, _ = extreme_eigenvalues_seeded(M, num_squarings)
    return lam_lo, lam_hi


def extreme_eigenvalues_warm(M, vhi, uhi, vlo, ulo, lam_prev,
                             num_steps: int = 16):
    """(lam_lo, lam_hi, new seeds, lam) with eigenvector estimates carried
    across solver iterations.

    The iterate moves by a bounded geodesic step per iteration, so shifted
    power iteration from the previous iteration's eigenvector estimates
    converges in a handful of matvecs.  M (..., n, n) has a real spectrum;
    vhi/uhi/vlo/ulo (..., n) are right/left eigenvector seeds for the
    max/min ends; lam_prev (..., 2) the previous (lo, hi) estimates.  The
    shift is 4 * max|lam_prev| (the per-iteration drift bound), capped by
    the Frobenius norm.

    On a CUDA card the estimate replays one captured CUDA graph per key
    (``_graph_key``): the same kernels on the same values as the eager
    body, so the same bits, in one launch instead of about 480.  Inputs a
    graph cannot reproduce to the bit (not contiguous, not at the start of
    an allocation, needing gradients, or met inside another capture) run
    the eager body, as every CPU tensor does.  Counted on the card:
    ``sym.warm.calls``, ``sym.warm.captures``, ``sym.warm.replays``.

    reference role: PrepareStep / GetWeightedSlackEigenvalues norms
    (psd_constraint.cc:63-77).
    """
    if M.device.type != "cuda":
        return _warm_eager(M, vhi, uhi, vlo, ulo, lam_prev, num_steps)
    counters["sym.warm.calls"] += 1
    inputs = (M, vhi, uhi, vlo, ulo, lam_prev)
    if not _graphable(inputs):
        return _warm_eager(*inputs, num_steps)
    key = _graph_key(inputs, num_steps,
                     torch.cuda.current_stream(M.device).cuda_stream)
    return _replay(key, inputs, num_steps)


def extreme_eigenvalues_cold_or_warm(M, carried):
    """(lam_lo, lam_hi, seeds, lam) of M (S, ..., n, n): per scenario, the
    cold estimator where all of the carried ``lam`` is 0 (identity
    initialization, warmstart aborts), else the warm one from the carried
    seeds ``vhi``, ``uhi``, ``vlo``, ``ulo`` (a PSDState or HermState).

    The JAX package picks one with a ``lax.cond`` on ``max|lam| == 0``,
    which vmap makes a choice per scenario.  Here the cold estimator runs
    only when some scenario is cold (one host read, ``sync.cone.cold``)
    and a select picks per scenario.  The warm step count grows with the
    order, as in the JAX package (n = 300 needs more than 16 steps)."""
    lam = carried.lam
    is_cold = torch.amax(torch.abs(lam), dim=tuple(range(1, lam.dim()))) == 0.0
    counters["sync.cone.cold"] += 1
    n_cold = int(is_cold.sum())
    cold = extreme_eigenvalues_seeded(M) if n_cold else None
    if n_cold == is_cold.shape[0]:
        return cold
    warm = extreme_eigenvalues_warm(
        M, carried.vhi, carried.uhi, carried.vlo, carried.ulo, lam,
        num_steps=max(16, min(64, M.shape[-1] // 6)),
    )
    if cold is None:
        return warm

    def pick(c, w):
        if isinstance(c, tuple):
            return tuple(pick(x, y) for x, y in zip(c, w))
        return torch.where(is_cold.reshape((-1,) + (1,) * (c.dim() - 1)), c, w)

    return pick(cold, warm)


# At most this many captured estimators are kept; each holds its static
# buffers and a private memory pool (from the shapes, about 50 MB at 256
# cones of n = 100: M twice in f64 and once in f32).
GRAPH_CAPACITY = 16
# Fresh blocks of the caching allocator, the static buffers among them,
# start on a 512-byte boundary.  An input on a 256-byte one passes the
# alignment tests of cuBLAS and of ATen's vectorized loads as they do, so
# the same kernels run in the same order.
_ALIGNMENT = 256


class _GraphCache:
    """At most ``capacity`` entries by key; a lookup makes its entry the
    newest, and a put into a full cache evicts the oldest."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries = collections.OrderedDict()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry):
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)


_graphs = _GraphCache(GRAPH_CAPACITY)
# Ranks of parallel/launch.py run as threads of one process.
_graphs_lock = threading.Lock()
_capture_streams = {}


def _graph_key(inputs, num_steps: int, stream=None):
    """What picks the kernels of the eager body: the inputs' shapes and
    dtypes, the device, the step count and the global matmul settings
    (solver/loop.py's _no_tf32 changes them for a solve); and the stream,
    so that threads on other streams never share static buffers."""
    return (tuple((tuple(x.shape), x.dtype) for x in inputs), inputs[0].device,
            int(num_steps), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled(), stream)


def _replay(key, inputs, num_steps: int):
    """Replay the graph of ``key``, captured first if the cache lacks it."""
    with _graphs_lock:
        graph = _graphs.get(key)
        if graph is None:
            graph = _WarmGraph(inputs, num_steps)
            _graphs.put(key, graph)
            counters["sym.warm.captures"] += 1
        counters["sym.warm.replays"] += 1
        return graph.replay(inputs)


def _graphable(inputs) -> bool:
    return (all(x.is_contiguous() and not x.requires_grad
                and x.data_ptr() % _ALIGNMENT == 0 for x in inputs)
            and not torch.cuda.is_current_stream_capturing())


class _WarmGraph:
    """The eager body captured into static input buffers."""

    def __init__(self, inputs, num_steps: int):
        device = inputs[0].device
        self.static = tuple(x.clone() for x in inputs)
        stream = _capture_streams.get(device)
        if stream is None:
            stream = _capture_streams[device] = torch.cuda.Stream(device)
        # A run on the capture stream first, as torch.cuda.graphs advises:
        # cuBLAS's handle and workspace for it exist before the capture.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            _warm_eager(*self.static, num_steps)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            lam_lo, lam_hi, seeds, lam = _warm_eager(*self.static, num_steps)
        self.outputs = (lam_lo, lam_hi, *seeds, lam)

    def replay(self, inputs):
        for buf, x in zip(self.static, inputs):
            buf.copy_(x)
        self.graph.replay()
        # Copies: the next replay overwrites the outputs, and the cone keeps
        # the seeds and lam across passes.
        lam_lo, lam_hi, vhi, uhi, vlo, ulo, lam = (o.clone() for o in self.outputs)
        return lam_lo, lam_hi, (vhi, uhi, vlo, ulo), lam


def _warm_eager(M, vhi, uhi, vlo, ulo, lam_prev, num_steps: int):
    """The body of extreme_eigenvalues_warm, one torch call at a time."""
    fro = torch.sqrt(torch.sum(M * M, dim=(-2, -1))) + 1e-30
    sig_warm = 4.0 * torch.amax(torch.abs(lam_prev), dim=-1)
    # The 1.25 margin keeps sigma strictly above rho(M): with sigma == rho
    # exactly, M + sigma I ~ 0 and the power iteration collapses to zero.
    sigma = 1.25 * torch.where(
        sig_warm > 1e-6 * fro, torch.minimum(sig_warm, fro), fro
    )
    # The sweep only produces eigenvector estimates, so on f64 inputs it
    # runs in f32, as in the JAX package.
    in_dtype = M.dtype
    it_dtype = torch.float32 if in_dtype == torch.float64 else in_dtype
    Mi = M.to(it_dtype)
    sig = sigma[..., None].to(it_dtype)

    def norm(v):
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)

    Mt = Mi.transpose(-2, -1)
    vh, uh, vl, ul = (norm(v.to(it_dtype)) for v in (vhi, uhi, vlo, ulo))
    for _ in range(num_steps):
        # One read of M (and one of M^T) drives both ends: stack the
        # max-end and min-end vectors into a 2-column block.
        MV = Mi @ torch.stack([vh, vl], dim=-1)  # (..., n, 2)
        MtU = Mt @ torch.stack([uh, ul], dim=-1)
        vh = norm(MV[..., 0] + sig * vh)
        vl = norm(sig * vl - MV[..., 1])
        uh = norm(MtU[..., 0] + sig * uh)
        ul = norm(sig * ul - MtU[..., 1])
    vhi, uhi, vlo, ulo = (x.to(in_dtype) for x in (vh, uh, vl, ul))

    def rq(u, v, prev):
        Mv = (M @ v[..., None])[..., 0]
        uv = torch.sum(u * v, dim=-1)
        vv = torch.sum(v * v, dim=-1)
        two = torch.sum(u * Mv, dim=-1) / uv
        one = torch.sum(v * Mv, dim=-1) / vv
        lam = torch.where(
            torch.abs(uv)
            > 1e-6 * torch.sqrt(vv) * torch.linalg.vector_norm(u, dim=-1),
            two,
            one,
        )
        # Degenerate iteration (zero vector / non-finite RQ): carry the
        # previous estimate forward rather than reporting 0.
        return torch.where(torch.isfinite(lam) & (vv > 1e-30), lam, prev)

    lam_hi = rq(uhi, vhi, lam_prev[..., 1])
    lam_lo = rq(ulo, vlo, lam_prev[..., 0])
    lam = torch.stack([lam_lo, lam_hi], dim=-1)
    return lam_lo, lam_hi, (vhi, uhi, vlo, ulo), lam
