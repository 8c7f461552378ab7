"""The port's cost-model tools: ``cost_fit`` (measure the network ladder
and fit the model's coefficients), ``cost_validate`` (the rank gate) and
``autotune`` (search the knobs with the model and write a tuned
deployment).  Each runs as ``python -m repro_torch.tools.<name>``."""
