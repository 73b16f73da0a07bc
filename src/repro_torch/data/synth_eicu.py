"""Synthetic eICU-like cohort generator.

The real eICU Collaborative Research Database is PhysioNet-credential-gated
and unavailable offline (repro band 2 — data gate).  This module simulates a
cohort that matches the *published statistics* of the paper's preprocessed
data (Table 2) and — critically for the recruitment technique — its
*non-IID multi-hospital structure*:

  * 189 hospitals (clients) after preprocessing, 89,127 stays total;
  * power-law hospital sizes (a few large academic centers, many small ones);
  * global LoS ~ lognormal with mean 3.69 days / median 2.27 days;
  * per-hospital LoS distribution *shift and scale* (case-mix heterogeneity),
    so local target histograms genuinely diverge from the global one;
  * 38 features (20 temporal x 24 hourly steps + 18 static), generated from a
    latent severity variable so LoS is learnable from the features;
  * train / val / test = 62,375 / 13,376 / 13,376 split at the *patient*
    level across all hospitals (test set contains patients from hospitals
    that may not be recruited, matching the paper's evaluation protocol).

Everything is deterministic in the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# --- published cohort constants (paper Table 2) ---------------------------
NUM_HOSPITALS = 189
TOTAL_STAYS = 89_127
TRAIN_FRACTION = 62_375 / TOTAL_STAYS
VAL_FRACTION = 13_376 / TOTAL_STAYS
NUM_TEMPORAL = 20
NUM_STATIC = 18
NUM_HOURS = 24
# lognormal(mu0, sigma0) gives median exp(mu0)=2.27d, mean exp(mu0+s^2/2)=3.69d
LOS_MU0 = float(np.log(2.27))
LOS_SIGMA0 = float(np.sqrt(2.0 * np.log(3.69 / 2.27)))


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    num_hospitals: int = NUM_HOSPITALS
    total_stays: int = TOTAL_STAYS
    num_temporal: int = NUM_TEMPORAL
    num_static: int = NUM_STATIC
    num_hours: int = NUM_HOURS
    # non-IID strength: stddev of per-hospital lognormal-mu shift and the
    # range of the sigma scaling.  0 shift/1 scale = IID hospitals.
    hospital_mu_shift: float = 0.35
    hospital_sigma_scale: tuple[float, float] = (0.75, 1.30)
    min_hospital_size: int = 25
    size_power: float = 1.3  # pareto tail exponent for hospital sizes
    # Observation / severity noise calibrated so a well-trained central GRU
    # lands near the paper's Table 4 (MAE ~2.2, MSLE ~0.33): first-24h ICU
    # features only weakly predict LoS in the real cohort, and the synthetic
    # cohort must reproduce that difficulty, not just the marginals.
    noise: float = 1.0       # observation noise on features
    severity_noise: float = 1.05  # latent severity decoupling from true LoS
    # per-hospital feature-noise multiplier range: (1.0, 1.0) = homogeneous
    # data quality; widen (e.g. (0.7, 2.5)) to model sites with poor charting
    # whose updates actively hurt the federation (the recruitment target).
    hospital_noise_scale: tuple[float, float] = (1.0, 1.0)
    # "global" = one patient-level permutation across all hospitals (the
    # paper's protocol); "stratified" = the same fractions applied within
    # every hospital, so local split sizes carry no sampling noise (the
    # standard multi-site alternative — and what keeps the vectorized
    # engine's shared step axis tight at paper scale).
    split_mode: str = "global"
    seed: int = 0

    def scaled(self, factor: float) -> "CohortConfig":
        """Smaller cohort for tests: scale total stays, keep structure."""
        return dataclasses.replace(
            self,
            total_stays=max(int(self.total_stays * factor), self.num_hospitals * 4),
            min_hospital_size=max(2, int(self.min_hospital_size * factor)),
        )


@dataclasses.dataclass
class Cohort:
    """Materialized synthetic cohort.

    ``x_temporal``: (N, 24, 20) float32 — hourly vitals/labs.
    ``x_static``:   (N, 18) float32 — demographics, admission info.
    ``y``:          (N,) float32 — LoS in fractional days.
    ``hospital_id``: (N,) int32 — originating hospital in [0, H).
    ``split``:      (N,) int8 — 0 train / 1 val / 2 test.
    """

    x_temporal: np.ndarray
    x_static: np.ndarray
    y: np.ndarray
    hospital_id: np.ndarray
    split: np.ndarray
    config: CohortConfig

    TRAIN, VAL, TEST = 0, 1, 2

    @property
    def num_hospitals(self) -> int:
        return self.config.num_hospitals

    def mask(self, split: int) -> np.ndarray:
        return self.split == split

    def fused_features(self) -> np.ndarray:
        """Temporal fused with broadcast static features: (N, 24, 38).

        Cached: at full paper scale this is a ~330 MB materialization, and
        drivers like ``run_paper_scale`` walk the same cohort through many
        settings/engines — building it once instead of per run_setting call.
        """
        cached = getattr(self, "_fused", None)
        if cached is None:
            static_tiled = np.repeat(self.x_static[:, None, :], self.x_temporal.shape[1], axis=1)
            cached = np.concatenate([self.x_temporal, static_tiled], axis=-1).astype(np.float32)
            self._fused = cached
        return cached

    def client_arrays(self, hospital: int, split: int) -> tuple[np.ndarray, np.ndarray]:
        """(fused features, y) for one hospital and split."""
        m = (self.hospital_id == hospital) & (self.split == split)
        return self.fused_features()[m], self.y[m]

    def client_sizes(self, split: int = TRAIN) -> np.ndarray:
        sizes = np.zeros(self.num_hospitals, dtype=np.int64)
        ids, counts = np.unique(self.hospital_id[self.split == split], return_counts=True)
        sizes[ids] = counts
        return sizes


def _hospital_sizes(rng: np.random.Generator, cfg: CohortConfig) -> np.ndarray:
    """Power-law sizes summing exactly to total_stays, each >= min size."""
    raw = rng.pareto(cfg.size_power, size=cfg.num_hospitals) + 1.0
    budget = cfg.total_stays - cfg.min_hospital_size * cfg.num_hospitals
    if budget < 0:
        raise ValueError("total_stays too small for min_hospital_size * num_hospitals")
    extra = np.floor(raw / raw.sum() * budget).astype(np.int64)
    sizes = extra + cfg.min_hospital_size
    # distribute the rounding remainder to the largest hospitals
    remainder = cfg.total_stays - int(sizes.sum())
    order = np.argsort(-sizes)
    sizes[order[:remainder]] += 1
    assert sizes.sum() == cfg.total_stays
    return sizes


def generate_cohort(config: CohortConfig | None = None, seed: int | None = None) -> Cohort:
    cfg = config or CohortConfig()
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
    rng = np.random.default_rng(cfg.seed)

    sizes = _hospital_sizes(rng, cfg)
    hospital_id = np.repeat(np.arange(cfg.num_hospitals, dtype=np.int32), sizes)
    n = cfg.total_stays

    # --- per-hospital non-IID LoS ------------------------------------------
    mu_shift = rng.normal(0.0, cfg.hospital_mu_shift, size=cfg.num_hospitals)
    sig_scale = rng.uniform(*cfg.hospital_sigma_scale, size=cfg.num_hospitals)
    mu_h = LOS_MU0 + mu_shift
    sigma_h = LOS_SIGMA0 * sig_scale
    log_los = rng.normal(mu_h[hospital_id], sigma_h[hospital_id])
    y = np.exp(log_los).astype(np.float32)
    y = np.clip(y, 2.0 / 24.0, 120.0)  # at least 2h, at most 120d in ICU

    # --- latent severity drives the features -------------------------------
    # severity = standardized log-LoS within the global distribution + noise,
    # so features carry real signal about the target.
    severity = (np.log(y) - LOS_MU0) / LOS_SIGMA0
    severity = severity + rng.normal(0.0, cfg.severity_noise, size=n)

    hosp_offset_t = rng.normal(0.0, 0.3, size=(cfg.num_hospitals, cfg.num_temporal))
    hosp_offset_s = rng.normal(0.0, 0.3, size=(cfg.num_hospitals, cfg.num_static))
    hosp_noise = rng.uniform(*cfg.hospital_noise_scale, size=cfg.num_hospitals)

    # temporal: per-feature loading on severity, hourly trend + diurnal tone
    load_t = rng.normal(0.0, 1.0, size=cfg.num_temporal)
    trend = rng.normal(0.0, 0.15, size=cfg.num_temporal)
    hours = np.arange(cfg.num_hours, dtype=np.float32)
    base = severity[:, None] * load_t[None, :]                       # (N, F_t)
    x_temporal = (
        base[:, None, :]
        + trend[None, None, :] * (hours[None, :, None] / cfg.num_hours) * severity[:, None, None]
        + 0.10 * np.sin(2 * np.pi * hours[None, :, None] / 24.0)
        + hosp_offset_t[hospital_id][:, None, :]
        + hosp_noise[hospital_id][:, None, None]
        * rng.normal(0.0, cfg.noise, size=(n, cfg.num_hours, cfg.num_temporal))
    ).astype(np.float32)

    # static: age/gender/diagnosis-like one-hot-ish blocks + severity loading
    load_s = rng.normal(0.0, 0.8, size=cfg.num_static)
    x_static = (
        severity[:, None] * load_s[None, :]
        + hosp_offset_s[hospital_id]
        + hosp_noise[hospital_id][:, None]
        * rng.normal(0.0, cfg.noise, size=(n, cfg.num_static))
    ).astype(np.float32)
    # a few genuinely categorical static columns (one-hot over 4 "units")
    unit = rng.integers(0, 4, size=n)
    for k in range(4):
        x_static[:, k] = (unit == k).astype(np.float32)

    # --- splits ------------------------------------------------------------
    split = np.full(n, Cohort.TEST, dtype=np.int8)
    if cfg.split_mode == "stratified":
        # the same fractions within every hospital: per-client split sizes
        # are deterministic in the hospital size, no cross-site noise
        for h in range(cfg.num_hospitals):
            idx = rng.permutation(np.flatnonzero(hospital_id == h))
            k_train = int(round(TRAIN_FRACTION * len(idx)))
            k_val = int(round(VAL_FRACTION * len(idx)))
            split[idx[:k_train]] = Cohort.TRAIN
            split[idx[k_train : k_train + k_val]] = Cohort.VAL
    elif cfg.split_mode == "global":
        perm = rng.permutation(n)
        n_train = int(round(TRAIN_FRACTION * n))
        n_val = int(round(VAL_FRACTION * n))
        split[perm[:n_train]] = Cohort.TRAIN
        split[perm[n_train : n_train + n_val]] = Cohort.VAL
    else:
        raise ValueError(f"unknown split_mode {cfg.split_mode!r}")

    return Cohort(
        x_temporal=x_temporal,
        x_static=x_static,
        y=y,
        hospital_id=hospital_id,
        split=split,
        config=cfg,
    )
