"""KMeans on the device (counterpart of
``pyspark_tf_gke_tpu/etl/kmeans.py``): the reference's classical-ML
workload (k 25, seed 1, maxIter 1000) with Spark MLlib's behaviour.

* k-means++ (D^2-weighted) seeding in numpy from
  ``np.random.default_rng(seed)``: the initial centres are the JAX
  module's exactly.
* Lloyd steps on the device: the ``[n, k]`` squared distances as
  ``max(|x|^2 - 2 x.c^T + |c|^2, 0)`` (one matmul), a row argmin, the
  centre sums as ``onehot^T @ x`` and the counts as the one-hot's
  column sums; an empty cluster keeps its centre. The loop stops when
  every centre moves by at most ``tol`` or at ``max_iter``; ``n_iter``
  counts the iterations as the JAX ``while_loop`` counts them.
* The norms and both products accumulate in f64 and round once to f32,
  so the card and the host compute the same f32 distances and centres.
  Accumulated in f32, they follow the BLAS's summation order, which
  differs between cuBLAS and MKL and with MKL's thread count; on the
  18,154-row reference CSV a row's two nearest centres can lie within
  a few 1e-6 of each other, and such an order flips it: the fit then
  takes another path and stops an iteration apart (64 and 65).
* The loop runs ``CHECK_EVERY`` iterations between host reads of its
  stop flag. An iteration after the stop is computed but masked: the
  centres stay those of the iteration that stopped, and ``n_iter`` does
  not move.
* ``silhouette_score`` is the squared-Euclidean silhouette in 1024-row
  blocks, each point's own zero distance excluded.

* ``mesh=`` (a ``DeviceMesh``, ``parallel/``) splits the rows over the
  data axes, as the JAX fit places them on ``P(("dp", "fsdp"))``: each
  rank holds one contiguous block of rows (``np.array_split``), and the
  f64 per-centre sums and the counts of every Lloyd step are summed
  over the ranks before the division, so every rank steps the same
  centres and a fit over ranks equals the one-process fit (the same
  ``n_iter``, the same centres).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu_torch.device import resolve_device

# Lloyd iterations between host reads of the stop flag
CHECK_EVERY = 8


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``[n, k]`` f32 squared Euclidean distances of f32 inputs; the norms
    and the product accumulate in f64 and round once to f32."""
    xd, cd = x.double(), centers.double()
    x_norm = (xd * xd).sum(1, keepdim=True).float()
    c_norm = (cd * cd).sum(1)[None, :].float()
    cross = (xd @ cd.T).float()
    return torch.clamp_min(x_norm - 2.0 * cross + c_norm, 0.0)


def lloyd_step(x: torch.Tensor, centers: torch.Tensor, group=None):
    """One Lloyd iteration: ``(new_centers, largest move)``; ``group``
    sums the centre sums and counts over the ranks that split the
    rows."""
    k = centers.shape[0]
    onehot = F.one_hot(torch.argmin(_sq_dists(x, centers), dim=1),
                       k).to(x.dtype)
    sums = onehot.T.double() @ x.double()
    counts = onehot.sum(0)
    if group is not None:
        torch.distributed.all_reduce(sums, group=group)
        torch.distributed.all_reduce(counts, group=group)
    sums = sums.float()
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts, 1.0)[:, None], centers)
    move = torch.sqrt(((new - centers) ** 2).sum(1)).max()
    return new, move


class KMeans:
    def __init__(self, k: int = 25, max_iter: int = 1000, tol: float = 1e-4,
                 seed: int = 1, device: Union[str, torch.device] = "cuda",
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh (parallel."
                                f"make_mesh), got {type(mesh).__name__}")
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centers: Optional[np.ndarray] = None
        self.n_iter: Optional[int] = None

    def _init_centers(self, x: np.ndarray) -> np.ndarray:
        """k-means++ (D^2-weighted) seeding, deterministic given seed."""
        rng = np.random.default_rng(self.seed)
        n = len(x)
        centers = np.empty((self.k, x.shape[1]), dtype=x.dtype)
        centers[0] = x[rng.integers(n)]
        d2 = ((x - centers[0]) ** 2).sum(1)
        for i in range(1, self.k):
            probs = d2 / max(d2.sum(), 1e-12)
            centers[i] = x[rng.choice(n, p=probs)]
            d2 = np.minimum(d2, ((x - centers[i]) ** 2).sum(1))
        return centers

    @torch.no_grad()
    def fit(self, x: np.ndarray) -> "KMeans":
        x = np.asarray(x, dtype=np.float32)
        if len(x) < self.k:
            raise ValueError(f"n={len(x)} rows < k={self.k}")
        init = self._init_centers(x)
        group = None
        if self.mesh is not None:
            from pyspark_tf_gke_tpu_torch.parallel.spmd import Spmd

            spmd = Spmd(self.mesh)
            x = np.array_split(x, spmd.batch_count)[spmd.batch_index]
            group = spmd.batch_group
        xd = torch.from_numpy(x).to(self.device)
        centers = torch.from_numpy(init).to(self.device)
        n_iter = torch.zeros((), dtype=torch.long, device=self.device)
        done = torch.zeros((), dtype=torch.bool, device=self.device)
        ran = 0
        while ran < self.max_iter:
            for _ in range(min(CHECK_EVERY, self.max_iter - ran)):
                new, move = lloyd_step(xd, centers, group)
                centers = torch.where(done, centers, new)
                n_iter += (~done).long()
                # the JAX loop's condition (move > tol), read after its body
                done = done | ~(move > self.tol)
            ran += CHECK_EVERY
            if bool(done):
                break
        self.centers = centers.cpu().numpy()
        self.n_iter = int(n_iter)
        return self

    @torch.no_grad()
    def _dists(self, x: np.ndarray) -> torch.Tensor:
        if self.centers is None:
            raise RuntimeError("fit() first")
        return _sq_dists(
            torch.from_numpy(np.asarray(x, dtype=np.float32)).to(self.device),
            torch.from_numpy(self.centers).to(self.device))

    def predict(self, x: np.ndarray) -> np.ndarray:
        return torch.argmin(self._dists(x), dim=1).cpu().numpy()

    def cost(self, x: np.ndarray) -> float:
        """Sum of squared distances to the closest centre (Spark's
        ``trainingCost``)."""
        return float(self._dists(x).min(dim=1).values.sum())


@torch.no_grad()
def silhouette_score(x: np.ndarray, labels: np.ndarray, block: int = 1024,
                     device: Union[str, torch.device] = "cuda") -> float:
    """Mean squared-Euclidean silhouette over all points, in row blocks
    so the ``[n, n]`` distance matrix never fully exists."""
    dev = resolve_device(device)
    xd = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
    lab = torch.from_numpy(np.asarray(labels)).long().to(dev)
    k = int(lab.max()) + 1
    onehot = F.one_hot(lab, k).to(xd.dtype)
    counts = onehot.sum(0)
    scores = []
    for start in range(0, xd.shape[0], block):
        lb = lab[start:start + block]
        sums = _sq_dists(xd[start:start + block], xd) @ onehot  # [b, k]
        own = sums.gather(1, lb[:, None])[:, 0]
        own_count = counts[lb]
        a = own / torch.clamp_min(own_count - 1, 1.0)  # self excluded
        other = torch.where(F.one_hot(lb, k).bool(), torch.inf,
                            sums / torch.clamp_min(counts, 1.0)[None, :])
        b = other.min(dim=1).values
        s = torch.where(own_count > 1,
                        (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12),
                        0.0)
        scores.append(s.cpu().numpy())
    return float(np.concatenate(scores).mean())
