"""Training: LR schedules, EMAs, the train state and step, checkpoints and
the ndata-driven loop (port of climate2weather_tpu/training/)."""
