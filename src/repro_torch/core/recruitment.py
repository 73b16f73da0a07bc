"""Client recruitment (the paper's core contribution).

Prior to forming a federation, every candidate client ``c`` reports only the
tuple ``(P_co, n_c)`` — its local *target histogram* and sample size.  The
server computes per-client representativeness (paper eq. 4)::

    nu_c = gamma_dv * sum_bins | P_go/n_g - P_co/n_c |  +  gamma_sa * n_c^-0.5

(lower = more representative) and recruits greedily in ascending-nu order
until the cumulative representativeness crosses ``iota = gamma_th * nu_g``
with ``nu_g = sum_c nu_c`` (paper eq. 5).

Nothing here touches model parameters or raw features — recruitment is
model-agnostic by construction, which is why it composes with every
architecture in the zoo.

Two evaluation paths share the same scoring math:

- ``recruit`` materializes every disclosure and argsorts the population —
  the exact oracle, fine through ~10^3 clients (the paper's 189).
- ``recruit_streaming`` / ``StreamingRecruiter`` consume the disclosure
  stream in one bounded-memory pass for cross-device populations
  (10^4–10^6): a running global histogram, a bounded candidate pool of the
  lowest-nu clients, and a weighted nu-quantile sketch for the threshold.
  Populations that fit the exact buffer delegate to ``recruit`` verbatim,
  so the two paths agree exactly at paper scale.
"""

from __future__ import annotations

import dataclasses
import heapq
import warnings
from functools import cached_property
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.histogram import normalize


@dataclasses.dataclass(frozen=True)
class ClientStats:
    """What a candidate client discloses to the recruitment server."""

    client_id: int
    counts: np.ndarray  # per-bin target counts, shape (num_bins,)
    n: int              # local sample size

    def __post_init__(self) -> None:
        if self.n <= 0:
            raise ValueError(f"client {self.client_id}: sample size must be positive, got {self.n}")
        counts = np.asarray(self.counts)
        if np.any(counts < 0):
            raise ValueError(f"client {self.client_id}: negative histogram counts")
        mass = float(counts.sum())
        # A stay can lack an LoS label (mass < n) but the histogram can never
        # count more stays than the client reports having.
        if mass > self.n + 1e-9:
            raise ValueError(
                f"client {self.client_id}: histogram mass {mass} exceeds reported n={self.n}"
            )


@dataclasses.dataclass(frozen=True)
class RecruitmentConfig:
    gamma_dv: float = 0.5   # weight of target-distribution divergence
    gamma_sa: float = 0.5   # weight of the n_c^-0.5 sample-size term
    gamma_th: float = 0.1   # fraction of global representativeness to cover

    def __post_init__(self) -> None:
        if not (0.0 < self.gamma_th <= 1.0):
            raise ValueError(f"gamma_th must be in (0, 1], got {self.gamma_th}")
        if self.gamma_dv < 0 or self.gamma_sa < 0:
            raise ValueError("gamma weights must be non-negative")


# Paper section 6.2 presets.
BALANCED = RecruitmentConfig(gamma_dv=0.5, gamma_sa=0.5, gamma_th=0.1)
QUALITY_GREEDY = RecruitmentConfig(gamma_dv=1.0, gamma_sa=0.01, gamma_th=0.1)
DATA_GREEDY = RecruitmentConfig(gamma_dv=0.01, gamma_sa=1.0, gamma_th=0.1)

# Named presets, addressable from policy spec strings ("nu-greedy:balanced");
# the registry the Federation facade's recruitment stage resolves against.
RECRUITMENT_PRESETS: dict[str, RecruitmentConfig] = {
    "balanced": BALANCED,
    "quality-greedy": QUALITY_GREEDY,
    "data-greedy": DATA_GREEDY,
}


def preset_recruitment(name: str) -> RecruitmentConfig:
    """Look up a section-6.2 preset by name (``"balanced"`` etc.)."""
    if name not in RECRUITMENT_PRESETS:
        known = ", ".join(sorted(RECRUITMENT_PRESETS))
        raise ValueError(f"unknown recruitment preset {name!r}; choose from: {known}")
    return RECRUITMENT_PRESETS[name]


@dataclasses.dataclass(frozen=True)
class RecruitmentResult:
    recruited_ids: np.ndarray      # client ids, ascending-nu order
    nu: np.ndarray                 # per-client nu, aligned with ``client_ids``
    client_ids: np.ndarray         # all candidate ids (input order)
    nu_g: float                    # global representativeness (sum of nu)
    iota: float                    # recruitment threshold gamma_th * nu_g

    @property
    def num_recruited(self) -> int:
        return int(self.recruited_ids.size)

    @cached_property
    def _recruited_set(self) -> frozenset:
        # cached_property assigns through __dict__, so it works on the frozen
        # dataclass; built once, then membership is O(1) amortized.
        return frozenset(int(c) for c in self.recruited_ids)

    def is_recruited(self, client_id: int) -> bool:
        return int(client_id) in self._recruited_set


def _nu_against(
    counts: np.ndarray,
    n: np.ndarray,
    p_global: np.ndarray,
    config: RecruitmentConfig,
) -> np.ndarray:
    """nu_c for a (C, bins) batch of disclosures against a fixed p_global.

    The local histogram is normalized by its own mass, not the reported
    ``n``: a client whose stays are missing LoS labels (mass < n) still
    discloses a valid distribution, and the divergence term must compare
    distributions, not under-scaled ones.
    """
    mass = counts.sum(axis=1)
    p_local = counts / np.maximum(mass, 1.0)[:, None]
    divergence = np.abs(p_global[None, :] - p_local).sum(axis=1)
    return config.gamma_dv * divergence + config.gamma_sa * n ** -0.5


def representativeness(
    stats: Sequence[ClientStats],
    config: RecruitmentConfig,
) -> np.ndarray:
    """Per-client nu_c (paper eq. 4), aligned with ``stats`` order."""
    if not stats:
        raise ValueError("no candidate clients")
    counts = np.stack([np.asarray(s.counts, dtype=np.float64) for s in stats])
    n = np.array([s.n for s in stats], dtype=np.float64)
    # P_go = sum_c P_co (counts); P_go/n_g is the normalized global histogram.
    global_counts = counts.sum(axis=0)
    p_global = normalize(global_counts)
    return _nu_against(counts, n, p_global, config)


def _crossing_cutoff(cumulative: np.ndarray, iota: float, gamma_th: float) -> int:
    """Eq.-5 crossing: recruit up to and *including* the crossing client.

    ``side="left"`` finds the first prefix sum >= iota; that client is the
    crossing client, so the cutoff is its index + 1 — never one past it.  A
    relative tolerance keeps an exact mathematical tie (prefix == iota) from
    flipping to "one more client" when float rounding lands iota a ulp above
    the prefix, and ``gamma_th = 1`` short-circuits to the whole population
    so full-threshold recruitment cannot be lost to summation error.
    """
    num = int(cumulative.size)
    if num == 0:
        return 0
    if gamma_th >= 1.0:
        return num
    tol = 1e-12 * max(float(cumulative[-1]), 1.0)
    crossed = int(np.searchsorted(cumulative, iota - tol, side="left"))
    return min(crossed + 1, num)


def recruit(
    stats: Sequence[ClientStats],
    config: RecruitmentConfig = BALANCED,
) -> RecruitmentResult:
    """Greedy threshold recruitment (paper section 4.2).

    Sort nu ascending (most representative first), accumulate, and recruit
    every client up to and including the one at which the running sum crosses
    ``iota = gamma_th * nu_g``.  ``gamma_th = 1`` recruits everyone.
    """
    nu = representativeness(stats, config)
    client_ids = np.array([s.client_id for s in stats], dtype=np.int64)
    order = np.argsort(nu, kind="stable")
    nu_sorted = nu[order]
    cumulative = np.cumsum(nu_sorted)
    # nu_g accumulated in the *same* (sorted) order as the prefix sums, so
    # iota and cumulative[-1] share a rounding history and gamma_th = 1.0 is
    # exact by construction rather than hostage to summation order.
    nu_g = float(cumulative[-1])
    iota = config.gamma_th * nu_g
    cutoff = _crossing_cutoff(cumulative, iota, config.gamma_th)
    recruited = client_ids[order][:cutoff]
    return RecruitmentResult(
        recruited_ids=recruited,
        nu=nu,
        client_ids=client_ids,
        nu_g=nu_g,
        iota=iota,
    )


def recruitment_curve(
    stats: Sequence[ClientStats],
    config: RecruitmentConfig,
    gamma_ths: Sequence[float],
) -> list[tuple[float, int]]:
    """(gamma_th, num_recruited) pairs for the paper's Fig. 2 sweep."""
    out = []
    for g in gamma_ths:
        cfg = dataclasses.replace(config, gamma_th=g)
        out.append((float(g), recruit(stats, cfg).num_recruited))
    return out


# ---------------------------------------------------------------------------
# Streaming recruitment (population scale)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamingRecruitmentConfig:
    """Memory knobs for ``recruit_streaming``.

    ``exact_buffer``: populations up to this size are buffered whole and
    delegated to the exact ``recruit`` oracle — streaming and exact results
    are then identical, which covers the paper's 189-hospital scale with
    room to spare.

    ``pool_size``: above the buffer, only the ``pool_size`` lowest-nu
    candidates keep their full disclosure; everything else is folded into
    the global histogram and the nu-quantile sketch.  Size it at or above
    the number of recruits you expect — the result sets ``pool_exhausted``
    when the budget was too small to hold the crossing.

    ``sketch_bins``: resolution of the weighted nu histogram used to
    estimate where the iota threshold falls in the full population.
    """

    exact_buffer: int = 1024
    pool_size: int = 8192
    sketch_bins: int = 512

    def __post_init__(self) -> None:
        if self.exact_buffer < 0:
            raise ValueError(f"exact_buffer must be >= 0, got {self.exact_buffer}")
        if self.pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {self.pool_size}")
        if self.sketch_bins < 2:
            raise ValueError(f"sketch_bins must be >= 2, got {self.sketch_bins}")


@dataclasses.dataclass(frozen=True)
class StreamingRecruitmentResult:
    """What a one-pass recruitment run decides and how sure it is.

    ``mode`` is ``"exact"`` when the population fit the exact buffer (the
    participant set then matches ``recruit`` verbatim) and ``"sketch"``
    otherwise, where ``num_recruited`` carries the documented tolerance:
    candidates inside the pool are re-scored exactly against the final
    global histogram, so only the iota estimate (and therefore the cutoff
    position, not the ranking) inherits sketch error.
    """

    recruited_ids: np.ndarray   # ascending-nu order (arrival order at gamma_th=1)
    recruited_nu: np.ndarray    # nu of each recruited client, same order
    nu_g: float                 # global representativeness (estimate in sketch mode)
    iota: float                 # threshold gamma_th * nu_g
    clients_seen: int
    mode: str                   # "exact" | "sketch"
    pool_exhausted: bool        # True when pool_size was too small for the cutoff
    estimated_num_recruited: int  # independent estimate from the nu-quantile sketch

    @property
    def num_recruited(self) -> int:
        return int(self.recruited_ids.size)

    @cached_property
    def _recruited_set(self) -> frozenset:
        return frozenset(int(c) for c in self.recruited_ids)

    def is_recruited(self, client_id: int) -> bool:
        return int(client_id) in self._recruited_set


class _NuSketch:
    """Fixed-grid weighted histogram of nu over (0, hi].

    Tracks per-bin client counts and nu mass; ``count_until_mass`` walks the
    bins in ascending-nu order until the accumulated mass crosses a target,
    which is exactly the eq.-5 crossing evaluated on the sketch instead of
    the sorted population.
    """

    def __init__(self, hi: float, bins: int) -> None:
        self.hi = max(float(hi), 1e-9)
        self.bins = int(bins)
        self.counts = np.zeros(self.bins, dtype=np.int64)
        self.mass = np.zeros(self.bins, dtype=np.float64)

    def add(self, nu: float) -> None:
        idx = min(int(nu / self.hi * self.bins), self.bins - 1)
        self.counts[max(idx, 0)] += 1
        self.mass[max(idx, 0)] += nu

    def count_until_mass(self, target: float) -> int:
        """Clients recruited if the cumulative-nu threshold is ``target``."""
        cum = np.cumsum(self.mass)
        if cum.size == 0 or target <= 0.0:
            return 0
        j = int(np.searchsorted(cum, target, side="left"))
        if j >= self.bins:
            return int(self.counts.sum())
        before = int(self.counts[:j].sum())
        prior = float(cum[j - 1]) if j > 0 else 0.0
        bin_mass = float(self.mass[j])
        # Linear interpolation inside the crossing bin (+1: include the
        # crossing client, mirroring _crossing_cutoff).
        frac = (target - prior) / bin_mass if bin_mass > 0 else 0.0
        return min(before + int(frac * int(self.counts[j])) + 1, int(self.counts.sum()))


class StreamingRecruiter:
    """One-pass, bounded-memory nu-greedy recruitment.

    Feed disclosures with ``observe``/``extend``; ``finalize`` returns the
    decision.  State is O(exact_buffer + pool_size + sketch_bins) regardless
    of population size — nothing is materialized or argsorted at population
    scale.  (At ``gamma_th = 1`` everyone is recruited, so the id list —
    which *is* the output — is the only per-client state kept.)

    While streaming, each client is scored provisionally against the global
    histogram of the prefix seen so far; the prefix converges to the final
    histogram at O(1/P), so late provisional scores are nearly exact and the
    pool of lowest-nu candidates is re-scored exactly at finalize time.
    """

    def __init__(
        self,
        config: RecruitmentConfig = BALANCED,
        *,
        stream: StreamingRecruitmentConfig | None = None,
    ) -> None:
        self.config = config
        self.stream = stream if stream is not None else StreamingRecruitmentConfig()
        self._buffer: list[ClientStats] | None = []
        self._clients_seen = 0
        self._seq = 0
        self._global_counts: np.ndarray | None = None
        self._nu_prov_sum = 0.0
        # Max-heap (negated nu) of the pool_size lowest provisional-nu
        # candidates: (-nu_prov, seq, client_id, counts, n).
        self._pool: list[tuple[float, int, int, np.ndarray, float]] = []
        self._pool_dropped = 0
        self._sketch: _NuSketch | None = None
        self._ids: list[int] | None = [] if config.gamma_th >= 1.0 else None
        self._result: StreamingRecruitmentResult | None = None

    # -- ingest -------------------------------------------------------------

    def observe(self, s: ClientStats) -> None:
        if self._result is not None:
            raise RuntimeError("recruiter already finalized")
        self._clients_seen += 1
        if self._buffer is not None:
            self._buffer.append(s)
            if len(self._buffer) > self.stream.exact_buffer:
                self._spill()
            return
        self._ingest(np.asarray(s.counts, dtype=np.float64), s.client_id, float(s.n))

    def extend(self, stats_iter: Iterable[ClientStats]) -> None:
        for s in stats_iter:
            self.observe(s)

    def _spill(self) -> None:
        """Buffer overflow: switch from exact mode to sketch mode."""
        buf, self._buffer = self._buffer, None
        counts = np.stack([np.asarray(b.counts, dtype=np.float64) for b in buf])
        n = np.array([b.n for b in buf], dtype=np.float64)
        self._global_counts = counts.sum(axis=0)
        nu_hi = 2.0 * self.config.gamma_dv + self.config.gamma_sa
        self._sketch = _NuSketch(nu_hi, self.stream.sketch_bins)
        # Score the whole buffer against the buffer-prefix histogram.
        nu = _nu_against(counts, n, normalize(self._global_counts), self.config)
        for b, nu_c in zip(buf, nu):
            self._record(float(nu_c), b.client_id, np.asarray(b.counts, dtype=np.float64), float(b.n))

    def _ingest(self, counts: np.ndarray, client_id: int, n: float) -> None:
        self._global_counts += counts
        p_global = normalize(self._global_counts)
        mass = max(float(counts.sum()), 1.0)
        divergence = float(np.abs(p_global - counts / mass).sum())
        nu = self.config.gamma_dv * divergence + self.config.gamma_sa * n ** -0.5
        self._record(nu, client_id, counts, n)

    def _record(self, nu: float, client_id: int, counts: np.ndarray, n: float) -> None:
        self._nu_prov_sum += nu
        self._sketch.add(nu)
        if self._ids is not None:
            self._ids.append(int(client_id))
        entry = (-nu, self._seq, int(client_id), counts, n)
        self._seq += 1
        if len(self._pool) < self.stream.pool_size:
            heapq.heappush(self._pool, entry)
        elif entry > self._pool[0]:  # lower nu than the pool's current worst
            heapq.heapreplace(self._pool, entry)
            self._pool_dropped += 1
        else:
            self._pool_dropped += 1

    # -- decide -------------------------------------------------------------

    def finalize(self) -> StreamingRecruitmentResult:
        if self._result is not None:
            return self._result
        if self._clients_seen == 0:
            raise ValueError("no candidate clients")
        if self._buffer is not None:
            res = recruit(self._buffer, self.config)
            order = np.argsort(res.nu, kind="stable")
            self._result = StreamingRecruitmentResult(
                recruited_ids=res.recruited_ids,
                recruited_nu=res.nu[order][: res.num_recruited],
                nu_g=res.nu_g,
                iota=res.iota,
                clients_seen=self._clients_seen,
                mode="exact",
                pool_exhausted=False,
                estimated_num_recruited=res.num_recruited,
            )
            return self._result
        self._result = self._finalize_sketch()
        return self._result

    def _finalize_sketch(self) -> StreamingRecruitmentResult:
        p_global = normalize(self._global_counts)
        pool = sorted(self._pool, key=lambda t: t[1])  # arrival order: stable ties
        counts = np.stack([t[3] for t in pool])
        n = np.array([t[4] for t in pool], dtype=np.float64)
        ids = np.array([t[2] for t in pool], dtype=np.int64)
        nu_final = _nu_against(counts, n, p_global, self.config)
        # Global-sum estimate: pooled candidates contribute their exact final
        # nu; only the (high-nu, never-recruited) tail keeps its provisional
        # score, whose error vanishes as the prefix histogram converges.
        prov_in_pool = sum(-t[0] for t in pool)
        nu_g = self._nu_prov_sum - prov_in_pool + float(nu_final.sum())
        iota = self.config.gamma_th * nu_g

        if self.config.gamma_th >= 1.0:
            recruited = np.array(self._ids, dtype=np.int64)
            return StreamingRecruitmentResult(
                recruited_ids=recruited,
                recruited_nu=np.full(recruited.size, np.nan),
                nu_g=nu_g,
                iota=iota,
                clients_seen=self._clients_seen,
                mode="sketch",
                pool_exhausted=False,
                estimated_num_recruited=self._clients_seen,
            )

        order = np.argsort(nu_final, kind="stable")
        cumulative = np.cumsum(nu_final[order])
        cutoff = _crossing_cutoff(cumulative, iota, self.config.gamma_th)
        tol = 1e-12 * max(float(cumulative[-1]), 1.0)
        exhausted = bool(
            self._pool_dropped > 0 and float(cumulative[-1]) < iota - tol
        )
        if exhausted:
            warnings.warn(
                f"streaming recruitment pool ({self.stream.pool_size} candidates) "
                f"filled before the iota crossing; num_recruited is truncated — "
                f"raise StreamingRecruitmentConfig.pool_size",
                stacklevel=3,
            )
        return StreamingRecruitmentResult(
            recruited_ids=ids[order][:cutoff],
            recruited_nu=nu_final[order][:cutoff],
            nu_g=nu_g,
            iota=iota,
            clients_seen=self._clients_seen,
            mode="sketch",
            pool_exhausted=exhausted,
            estimated_num_recruited=self._sketch.count_until_mass(iota),
        )


def recruit_streaming(
    stats_iter: Iterable[ClientStats] | Iterator[ClientStats],
    config: RecruitmentConfig = BALANCED,
    *,
    stream: StreamingRecruitmentConfig | None = None,
) -> StreamingRecruitmentResult:
    """One-pass bounded-memory recruitment over a disclosure stream.

    Exact-``recruit`` parity whenever the population fits
    ``stream.exact_buffer`` (default 1024 ≥ the paper's 189); above that, a
    sketch-mode decision with a tolerance contract on ``num_recruited`` —
    see ``StreamingRecruitmentResult``.
    """
    recruiter = StreamingRecruiter(config, stream=stream)
    recruiter.extend(stats_iter)
    return recruiter.finalize()
