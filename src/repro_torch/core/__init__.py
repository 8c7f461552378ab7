"""Engine, execution plan, fusion planner, method ladder and deployment."""
