"""KMeans with its Lloyd step on the pass device (vaex_tpu/ml/cluster.py).

The reference's contract is kept: the traits, ``n_init`` restarts advanced
together, the init rows drawn by ``np.random.default_rng(random_state)``
from the first ``chunk_size`` rows in the reference's order of calls (so
both packages start from the same centroids), an empty cluster keeping its
centroid, the relative-inertia ``tol`` over every run, the best run chosen
by the last iteration's inertia, and ``inertias_`` / ``cluster_centers_`` /
``inertia_``.  The mechanics are the card's:

* the features are read a tile at a time on the pass device
  (``DataFrame._evaluate_tile``), and kept there for the whole fit while
  they take at most ``KEEP_BYTES``; only the init rows reach the host;
* a sub-tile's scores ``||c||^2 - 2 c.x`` are one product (``addmm``)
  over ``[R * K, rows]`` in float64 (at most ``DISTANCE_BYTES``); a row's
  assignment is its first least score, its squared distance that score
  plus ``||x||^2``, added to the [R, rows] minima only (the reference adds
  ``||x||^2`` to every entry of its [R, rows, K] matrix first);
* each run's per-cluster counts and sums are one additive grid: the
  assignment is the index, the D features the float channels, plus the
  count, through :func:`..ops.grid_plan.grid_sums` (B1 for K <= 128: its
  lane route adds floats in a fixed order, so a fit gives the same bits
  every time); no one-hot matrix is formed;
* a missing or NaN feature raises ValueError naming it (one reduction a
  tile), where the reference fits the masked-out data or NaN.

``predict`` assigns tile by tile on the pass device and returns a host int64
array; ``transform`` adds a virtual column over a function registered with
``add_function``, which the host stage runs and which assigns on
``settings.DEVICE``; both raise on a missing or NaN feature, as ``fit``
does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import settings
from ..ops import grid_plan
from ..ops.nullable import DictNA
from .transformations import Transformer

# a sub-tile's [R * K, rows] float64 distance matrix takes about this many bytes
DISTANCE_BYTES = 1 << 30
# the features of a frame stay on the pass device for the whole fit up to
# this many bytes; past it every iteration evaluates them again
KEEP_BYTES = 16 << 30


def scores(C, X):
    """[M, rows]: ``||c||^2 - 2 c.x`` of the centroids ``C`` [M, D] and the
    features ``X`` [D, rows], one product; a squared distance less
    ``||x||^2``."""
    return torch.addmm((C * C).sum(1)[:, None], C, X, alpha=-2.0)


def assign(C, X):
    """The nearest of the centroids ``C`` [K, D] to each row of ``X``
    [D, rows] (int64, the first on a tie), by ``-2 c.x + ||c||^2`` as the
    reference's ``assign`` (vaex_tpu/ml/cluster.py:52-56)."""
    return scores(C, X).argmin(0)


class KMeans(Transformer):
    """Lloyd's algorithm with ``n_init`` restarts advanced together
    (vaex_tpu/ml/cluster.py:62)."""

    snake_name = "kmeans"

    def __init__(self, features=None, n_clusters=2, init="random", n_init=1,
                 max_iter=300, tol=1e-4, random_state=None, verbose=False,
                 prediction_label="prediction_kmeans", chunk_size=4_000_000):
        super().__init__(features, "")
        self.n_clusters = int(n_clusters)
        self.init = init
        self.n_init = int(n_init)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = random_state
        self.verbose = verbose
        self.prediction_label = prediction_label
        self.chunk_size = int(chunk_size)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.inertias_ = None  # per iteration, the best run's inertia

    # -- the features --------------------------------------------------------
    def _walk(self, df):
        """Each tile of ``chunk_size`` rows as one [D, rows] float64 tensor
        on the pass device (the rows the filter keeps).  Raises ValueError
        after the walk where a feature held a missing or NaN value."""
        bad = None
        for i1 in range(0, df.dataset.row_count, self.chunk_size):
            i2 = min(i1 + self.chunk_size, df.dataset.row_count)
            cols, flags = [], []
            for f in self.features:
                value = df._evaluate_tile(f, i1, i2)
                if isinstance(value, DictNA):
                    raise TypeError(f"KMeans takes numeric features, {f!r} holds strings")
                data = value.data.to(torch.float64)
                cols.append(data)
                flags.append(value.mask.any() if value.mask is not None else
                             torch.zeros((), dtype=torch.bool, device=data.device))
            X = torch.stack(cols)
            tile_bad = torch.isnan(X).any(1) | torch.stack(flags)
            bad = tile_bad if bad is None else bad | tile_bad
            yield X
        if bad is not None and bool(bad.any()):
            names = [f for f, b in zip(self.features, bad.tolist()) if b]
            raise ValueError(f"KMeans: feature(s) {names} hold missing or NaN values; "
                             f"drop those rows (dropna) or fill them first")

    def _tiles(self, df):
        """A function giving the feature tiles: the tiles evaluated once and
        kept while they take at most ``KEEP_BYTES``, else a new walk."""
        if df.dataset.row_count * len(self.features) * 8 <= KEEP_BYTES:
            tiles = list(self._walk(df))
            return lambda: tiles
        return lambda: self._walk(df)

    def _init_centroids(self, tiles, rng):
        """[R, K, D] on the pass device: ``init`` as given, or per run K rows
        of the first ``chunk_size`` rows drawn as the reference draws them
        (vaex_tpu/ml/cluster.py:96-107)."""
        if isinstance(self.init, (list, tuple, np.ndarray)):
            c = np.asarray(self.init, dtype="f8")
            return torch.as_tensor(np.broadcast_to(c, (self.n_init,) + c.shape).copy())
        head, rows = [], 0
        for X in tiles():
            head.append(X[:, :self.chunk_size - rows])
            rows += head[-1].shape[1]
            if rows >= self.chunk_size:
                break
        X0 = torch.cat(head, dim=1)
        picks = [rng.choice(X0.shape[1], size=self.n_clusters, replace=False)
                 for _ in range(self.n_init)]
        index = torch.as_tensor(np.concatenate(picks), device=X0.device)
        return X0.index_select(1, index).T.reshape(self.n_init, self.n_clusters, -1)

    # -- fit -----------------------------------------------------------------
    def fit(self, df):
        if not self.features:
            raise ValueError("KMeans needs features")
        rng = np.random.default_rng(self.random_state)
        tiles = self._tiles(df)
        centroids = self._init_centroids(tiles, rng)
        R, K, D = centroids.shape
        prev_inertia = None
        self.inertias_ = []
        for iteration in range(self.max_iter):
            counts, sums, inertia = None, None, None
            for X in tiles():
                if counts is None:
                    centroids = centroids.to(X.device)
                    counts = torch.zeros((R, K), dtype=torch.int64, device=X.device)
                    sums = torch.zeros((R, D, K), dtype=torch.float64, device=X.device)
                    inertia = torch.zeros(R, dtype=torch.float64, device=X.device)
                self._tile_stats(centroids, X, counts, sums, inertia)
            # an empty cluster keeps its centroid
            new = torch.where(counts[:, :, None] > 0,
                              sums.transpose(1, 2) / counts.clamp(min=1)[:, :, None].double(),
                              centroids)
            centroids = new
            inertia_np = inertia.cpu().numpy()
            self.inertias_.append(float(inertia_np.min()))
            if self.verbose:
                print(f"KMeans iteration {iteration}, inertia {inertia_np}")
            if prev_inertia is not None:
                rel = np.abs(prev_inertia - inertia_np) / np.maximum(prev_inertia, 1e-300)
                if np.all(rel < self.tol):
                    break
            prev_inertia = inertia_np
        # the restart with the least inertia in the last iteration
        best = int(np.argmin(inertia_np))
        self.cluster_centers_ = centroids[best].cpu().numpy().tolist()
        self.inertia_ = float(inertia_np[best])
        return self

    def _tile_stats(self, centroids, X, counts, sums, inertia):
        """Add one tile's per-run cluster counts [R, K], sums [R, D, K] and
        inertia [R] in place, a sub-tile of at most ``DISTANCE_BYTES`` of
        distances at a time."""
        R, K, D = centroids.shape
        C = centroids.reshape(R * K, D)
        step = max(1, DISTANCE_BYTES // (R * K * 8))
        for a in range(0, X.shape[1], step):
            sub = X[:, a:a + step]
            nearest, best = scores(C, sub).view(R, K, -1).min(1)
            inertia += (nearest + (sub * sub).sum(0)).sum(1)
            for r in range(R):
                grid_plan.grid_sums(best[r].to(torch.int32), [], list(sub), K, True,
                                    out=([counts[r]], list(sums[r])))

    # -- predict / transform -------------------------------------------------
    def predict(self, df):
        outs = []
        centers = None
        for X in self._walk(df):
            if centers is None:
                centers = torch.as_tensor(np.asarray(self.cluster_centers_, dtype="f8"),
                                          device=X.device)
            outs.append(assign(centers, X))
        if not outs:
            return np.empty(0, np.int64)
        return torch.cat(outs).cpu().numpy()

    def transform(self, df):
        df = df.copy()
        centers = np.asarray(self.cluster_centers_, dtype="f8")
        features = [str(f) for f in self.features]

        def _predict(*cols):
            bad = [f for f, c in zip(features, cols)
                   if np.ma.getmaskarray(c).any() or np.isnan(np.ma.getdata(c)).any()]
            if bad:
                raise ValueError(f"KMeans: feature(s) {bad} hold missing or NaN values")
            device = torch.device(settings.DEVICE)
            X = torch.stack([torch.as_tensor(np.asarray(c, dtype="f8")) for c in cols])
            return assign(torch.as_tensor(centers, device=device), X.to(device)).cpu().numpy()

        name = df.add_function("kmeans_predict", _predict, vectorize=True, unique=True)
        df[self.prediction_label] = f"{name}({', '.join(map(str, self.features))})"
        return df
