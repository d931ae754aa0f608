"""Layout of the per-label search-health row every family core returns.

Reference parity: ``hyperopt_tpu/diagnostics.py`` (the row layout only;
the ``SearchStats`` classifier that consumes it is not ported yet).
"""

#: columns of the per-label diagnostic row every family core appends to
#: the suggest output (f32; see algos/tpe_device.py)
DIAG_COLS = 8

# columns: below/above component counts, max score, log-mean-exp of the
# scores, softmax mass of the top-D_EI_TOP_K candidates, then per family
#   cont: sigma_min_rel, sigma_mean_rel, sigma_floor_frac
#         (below-mixture sigmas over real components, / prior_sigma)
#   idx:  n_distinct_obs, dup_argmax_frac, support
D_EI_TOP_K = 16     # the k of the top-k mass reduction
