"""Substitution models and model factories.

Re-derivation of the reference model layer
(/root/reference/src/Model.h, ModelFactory.{h,cpp}, ModelFactoryWag.cpp,
ModelFactoryDarwin.cpp, ModelFactoryEcm.cpp, ModelFactoryCustom.h,
ModelFactoryPlusF.h) in numpy:

* ``P(d) = V · diag(exp(sigma·d)) · Vi`` with (V, sigma, Vi) from one host
  eigendecomposition of the normalized rate matrix Q — the batched expm:
  the eigendecomposition happens once per Q, after which P for a whole batch
  of branch lengths is a single einsum (see distances/ml.py::_batched_P).
* Empirical matrices (WAG / GONNET-Darwin / ECM) are loaded from extracted
  .npz data files (tools/extract_matrices.py).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
from ..errors import ParityError

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclass
class Model:
    """Model<ALPHABET> (reference: Model.h:8-24)."""
    M: np.ndarray          # joint prob diag(pi)·P
    P: np.ndarray          # e^{Qd}
    Q: np.ndarray
    pi: np.ndarray
    delta: float
    epsilon: float
    distance: float
    divergence: float


def _eig_decompose(Q: np.ndarray):
    sigma, V = np.linalg.eig(Q)
    sigma = np.real(sigma)
    V = np.real(V)
    Vi = np.linalg.inv(V)
    return sigma, V, Vi


def _normalize_rate(Q: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Zero+refill diagonal, normalize to 1 expected subst/unit
    (ModelFactoryWag.cpp tail)."""
    Q = Q.copy()
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    Q /= -(freqs @ np.diag(Q))
    return Q


def parse_distance(distance: float, options):
    """(input distance) -> (distance, divergence), ModelFactory.h:104-127."""
    distance = max(0.0, distance)
    if options.mldist_flag or options.mldist_gap_flag:
        if math.isnan(distance):
            distance = 5.2
        dist = distance
        ed = math.exp(dist)
        divergence = -0.5 * (5.0 * ed - math.sqrt(45.0 * ed * ed - 20.0 * ed)) / ed
    else:
        if math.isnan(distance):
            distance = 1.0
        if distance > 0.85:
            dist = 5.2
        else:
            dist = -math.log(1.0 - distance - 0.2 * distance * distance)
        divergence = distance
    dist = max(min(dist, options.max_dist), options.min_dist)
    divergence = max(min(divergence, options.max_pdist), options.min_pdist)
    return dist, divergence


class ModelFactory:
    """Base factory: holds normalized Q, its eigendecomposition, and freqs."""

    def __init__(self, Q: np.ndarray, freqs: np.ndarray):
        self.freqs = freqs
        self.Q = Q
        self.sigma, self.V, self.Vi = _eig_decompose(Q)

    # -- indel parameter hooks (ModelFactory.h:92-101) ------------------
    def get_epsilon(self, distance: float, options) -> float:
        return options.gapext_prob

    def get_delta(self, distance: float, options) -> float:
        return (1.0 - math.exp(-distance * options.indel_rate)) / 2.0

    # ------------------------------------------------------------------
    def P_of(self, distance: float) -> np.ndarray:
        return (self.V * np.exp(self.sigma * distance)) @ self.Vi

    def get_model(self, distance: float, options,
                  gap_distance: float = None) -> Model:
        """ModelFactory::getModel (ModelFactory.h:49-90). When
        ``gap_distance`` is given, epsilon/delta come from it while the
        substitution matrices come from ``distance``."""
        if gap_distance is not None:
            gdist, _ = parse_distance(gap_distance, options)
            epsilon = self.get_epsilon(gdist, options)
            delta = self.get_delta(gdist, options)
            dist, divergence = parse_distance(distance, options)
        else:
            dist, divergence = parse_distance(distance, options)
            epsilon = self.get_epsilon(dist, options)
            delta = self.get_delta(dist, options)

        P = self.P_of(dist)
        M = self.freqs[:, None] * P
        if options.mldist_flag or options.mldist_gap_flag:
            divergence = 1.0 - np.trace(M)
        return Model(M=M, P=P, Q=self.Q, pi=self.freqs, delta=delta,
                     epsilon=epsilon, distance=dist, divergence=divergence)


class EmpiricalModelFactory(ModelFactory):
    """WAG / Darwin / ECM: raw Q data with stationary freqs extracted as the
    null left-eigenvector of Qᵀ (ModelFactoryWag.cpp tail).

    Parity quirk (reproduced intentionally): the reference's ``data[]``
    arrays are stored row-major (the usual published form — e.g. WAG's pi_A
    would be 0.0866) but are mapped through a column-major ``Eigen::Map``.
    The compiled binary therefore runs with the *transposed* rate matrix,
    whose extracted stationary frequencies come out uniform (1/DIM).  We load
    the data exactly as the reference maps it so our models — and hence our
    alignments — match the reference binary bit-for-bit."""

    def __init__(self, name: str):
        raw = np.load(os.path.join(_DATA_DIR, "%s.npz" % name))["Q"]
        sigma2, V2 = np.linalg.eig(raw.T)
        sigma2 = np.real(sigma2)
        V2 = np.real(V2)
        izero = int(np.argmax(sigma2))
        # The reference asserts |sigma2| < 1e-8 here, but its release binary
        # is built with NDEBUG and the ECM data actually measures ~2e-7 —
        # so, like the binary, we do not abort.
        if abs(sigma2[izero]) >= 1e-6:
            raise ParityError("Invalid Q-Matrix")
        freqs = V2[:, izero] / V2[:, izero].sum()
        Q = _normalize_rate(raw, freqs)
        super().__init__(Q, freqs)


class WagModelFactory(EmpiricalModelFactory):
    def __init__(self):
        super().__init__("wag")


class DarwinModelFactory(EmpiricalModelFactory):
    """GONNET-style matrix with fitted gap parameters
    (ModelFactoryDarwin.cpp:435-445)."""

    def __init__(self):
        super().__init__("darwin")

    def get_epsilon(self, distance: float, options) -> float:
        return 0.72508680168437312

    def get_delta(self, distance: float, options) -> float:
        return min(0.5, 0.0052820194976999644 * distance ** 0.7434)


class EcmModelFactory(EmpiricalModelFactory):
    def __init__(self):
        super().__init__("ecm")


class CustomModelFactory(ModelFactory):
    """PAML-qmat-style file: lower-triangular exchangeabilities + freqs
    (ModelFactoryCustom.h:37-71)."""

    def __init__(self, text: str, dim: int):
        vals = [float(x) for x in text.split()]
        need = dim * (dim - 1) // 2 + dim
        if len(vals) < need:
            raise ParityError("error reading exchangeability matrix from file")
        Q = np.zeros((dim, dim))
        k = 0
        for i in range(1, dim):
            for j in range(i):
                v = vals[k]
                k += 1
                if not (v > 0 and v < math.inf):
                    raise ParityError(
                        "negative/infinity/zero value in exchangeability matrix")
                Q[j, i] = Q[i, j] = v
        freqs = np.array(vals[k:k + dim])
        if not np.all((freqs > 0) & (freqs < math.inf)):
            raise ParityError("negative/infinity/zero value in frequencies")
        freqs = freqs / freqs.sum()
        Q = _normalize_rate(Q, freqs)
        super().__init__(Q, freqs)


class PlusFModelFactory(ModelFactory):
    """+F: re-estimate equilibrium freqs from the data with a pseudo-count
    (ModelFactoryPlusF.h:72-106)."""

    def __init__(self, base: ModelFactory, options):
        self.base = base
        model = base.get_model(1.0, options)
        super().__init__(model.Q, model.pi)
        self.freqs_old = model.pi

    def get_epsilon(self, distance: float, options) -> float:
        return self.base.get_epsilon(distance, options)

    def get_delta(self, distance: float, options) -> float:
        return self.base.get_delta(distance, options)

    def estimate_freqs(self, value_arrays, options) -> None:
        """value_arrays: iterable of residue-value arrays for each sequence."""
        model = self.base.get_model(1.0, options)
        Q = model.Q.copy()
        self.freqs_old = model.pi
        dim = Q.shape[0]

        freqs = self.freqs_old * options.pseudo_count
        for vals in value_arrays:
            v = np.asarray(vals)
            v = v[(v >= 0) & (v < dim)]
            freqs = freqs + np.bincount(v, minlength=dim)

        self.freqs = freqs / freqs.sum()
        Q = Q * (self.freqs / self.freqs_old)[None, :]
        self.Q = _normalize_rate(Q, self.freqs)
        self.sigma, self.V, self.Vi = _eig_decompose(self.Q)


def get_default_model_factory(options, spec, seqs_values=None) -> ModelFactory:
    """ModelFactory::getDefault (ModelFactory.cpp:11-90).

    ``seqs_values``: {name: value-array} used by +F estimation (iterated in
    sorted-name order, matching the reference's std::map order).
    """
    if options.cmodel_file:
        with open(options.cmodel_file) as f:
            factory = CustomModelFactory(f.read(), spec.DIM)
    elif spec.name == "aa":
        factory = DarwinModelFactory() if options.darwin_flag else WagModelFactory()
    elif spec.name == "dna":
        raise ParityError("custom model file necessary for DNA alignments")
    else:  # codon
        factory = EcmModelFactory()

    if options.aafreqs_flag:
        plus_f = PlusFModelFactory(factory, options)
        ordered = [seqs_values[k] for k in sorted(seqs_values)]
        plus_f.estimate_freqs(ordered, options)
        factory = plus_f

    return factory
