"""Data: windowed training datasets, the resumable sampler and the ordered
prefetch loader (port of climate2weather_tpu/data/dataset.py); labeled grids
and quantiles (``grid``); normalization and layout helpers (``pipeline``);
the offline layer: patch extraction, the cdo-free merges and splits,
quantiles and the training file (``processing``), quantile-mapping debias
(``debias``), the synthetic generator (``synthetic``) and their command
line (``cli``)."""
