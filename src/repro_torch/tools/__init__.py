"""The port's tools, each run as ``python -m repro_torch.tools.<name>``:
the cost model's ``cost_fit`` (measure the network ladder and fit the
model's coefficients), ``cost_validate`` (the rank gate) and ``autotune``
(search the knobs with the model and write a tuned deployment); the
static analysis's ``lint`` (the R-rules), ``verify_sweep`` (the plan
verifier over the bundled grid) and ``sanitize`` (compute-sanitizer over
every kernel on the card)."""
