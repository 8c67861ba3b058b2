"""repro_torch.autotune: per-matrix format selection and kernel autotuning.

The paper's Fig. 9 argues per-matrix format tuning is valuable but — in
AlphaSparse form — prohibitively expensive. This package is the cheap
version: fingerprint the sparsity structure (`fingerprint`), predict
runtime and encoded size of each candidate format under a roofline
machine model (`cost_model`; the port's default is the card's, `H100`),
search the candidates with an optional measured-refinement budget
(`search.select`; ``measure=True`` times the candidates' CUDA kernels),
and remember decisions in a persistent cache (`cache.DecisionCache`).

    from repro_torch.autotune import select
    decision = select(csr_matrix)          # Decision(fmt="sell", ...)
    decision = select(csr_matrix, warm=False, budget=2)  # refine top-2

The port of the JAX package's ``repro.autotune``, with the same public
names plus `H100` and `device_kind`.
"""

from repro_torch.autotune.cache import (DecisionCache, atomic_merge_json,
                                        default_cache, default_cache_path)
from repro_torch.autotune.cost_model import (H100, V5E, Candidate, MachineModel,
                                             bcsr_config_name,
                                             bcsr_dtans_nbytes_estimate,
                                             candidate_time, candidates,
                                             collective_time, coo_nbytes,
                                             csr_nbytes, dtans_config_name,
                                             dtans_nbytes_estimate,
                                             memory_time, model_time,
                                             rgcsr_config_name,
                                             rgcsr_dtans_config_name,
                                             rgcsr_dtans_nbytes_estimate,
                                             rgcsr_nbytes, sell_nbytes,
                                             spmm_bytes, spmv_bytes,
                                             spmv_time, work_time)
from repro_torch.autotune.fingerprint import (Fingerprint, codeable_bits,
                                              fingerprint, lockstep_elems,
                                              max_group_nnz)
from repro_torch.autotune.measure import (NOISY_REL_IQR, CalibrationResult,
                                          TimingSample, calibrate,
                                          default_profiles_path,
                                          list_profiles, load_profile,
                                          measure_candidate, measure_config,
                                          measure_named, parse_config_name,
                                          save_profile, spmv_runner,
                                          time_kernel)
from repro_torch.autotune.oracle import oracle_best, oracle_times
from repro_torch.autotune.search import (ALL_FORMATS, Decision,
                                         choose_dtans_config, clear_memo,
                                         device_kind, select, shard_counts)
from repro_torch.sparse.registry import (DTANS_LANE_WIDTHS, CostTerms,
                                         FormatSpec,
                                         format_names, get_format,
                                         iter_formats, parse_config,
                                         register, unregister)
from repro_torch.sparse.rgcsr import RGCSR_GROUP_SIZES

__all__ = [
    "ALL_FORMATS", "CalibrationResult", "Candidate", "CostTerms",
    "Decision", "DecisionCache", "NOISY_REL_IQR", "TimingSample",
    "DTANS_LANE_WIDTHS", "Fingerprint", "FormatSpec", "H100",
    "MachineModel", "RGCSR_GROUP_SIZES", "V5E",
    "atomic_merge_json", "bcsr_config_name",
    "bcsr_dtans_nbytes_estimate", "calibrate",
    "candidate_time", "candidates", "choose_dtans_config", "clear_memo",
    "codeable_bits", "collective_time",
    "coo_nbytes", "csr_nbytes", "default_cache", "default_cache_path",
    "default_profiles_path", "device_kind",
    "dtans_config_name",
    "dtans_nbytes_estimate", "fingerprint", "format_names",
    "get_format", "iter_formats",
    "list_profiles", "load_profile", "lockstep_elems", "max_group_nnz",
    "measure_candidate", "measure_config", "measure_named",
    "memory_time", "model_time",
    "oracle_best", "parse_config", "parse_config_name",
    "oracle_times", "register", "rgcsr_config_name",
    "rgcsr_dtans_config_name",
    "rgcsr_dtans_nbytes_estimate", "rgcsr_nbytes", "save_profile",
    "select", "shard_counts",
    "sell_nbytes", "spmm_bytes", "spmv_bytes", "spmv_time",
    "time_kernel", "unregister", "work_time",
]
