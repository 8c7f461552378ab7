"""Static analysis of the port: findings, the plan verifier (shape flow
and the CUDA kernels' launch geometry) and the lint.  ``README.md`` has
the rules; ``repro_torch.tools.sanitize`` runs compute-sanitizer on the
card."""
