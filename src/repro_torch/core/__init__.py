"""The paper's system: algebra, planner, cost model, the MSJ and EVAL
operators, and the plan executor."""
