"""Static analysis of the port's execution plans: findings and the
shape-flow verifier."""
