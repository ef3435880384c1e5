"""Static checkpointing planners over captured traces (``repro.static``).

The Checkmate bridge: extract a heterogeneous checkpointing chain from a
``core.graph.Log`` (``chain``), plan on it with Chen segmentation / Chen
greedy / the heterogeneous optimal DP (``solvers``), floor every budget
cell with an LP relaxation over the full DAG (``lpbound``), and replay
plans through the real DTR runtime with the heuristic disabled
(``executor``) so static and online overheads share one accounting.
"""
from .chain import (Chain, ChainItem, LogView, build_view, extract_chain,
                    synthetic_chain, trim_touches)
from .executor import (PlanEval, PlanRuntime, StaticPlan, compile_plan,
                       evaluate_plan, execute_plan, predict_and_execute)
from .lpbound import LPBound, lp_lower_bound
from .panel import (Frontier, PlanPoint, best_static_plan, build_frontier,
                    compile_point, static_panel)
from .solvers import (SOLVERS, Plan, chen_greedy, chen_sqrt,
                      enumerate_optimal, optimal_dp, plan_cost, plan_peak)

__all__ = [
    "Chain", "ChainItem", "LogView", "build_view", "extract_chain",
    "synthetic_chain", "trim_touches",
    "Plan", "SOLVERS", "chen_greedy", "chen_sqrt", "enumerate_optimal",
    "optimal_dp", "plan_cost", "plan_peak",
    "LPBound", "lp_lower_bound",
    "PlanEval", "PlanRuntime", "StaticPlan", "compile_plan",
    "evaluate_plan", "execute_plan", "predict_and_execute",
    "Frontier", "PlanPoint", "best_static_plan", "build_frontier",
    "compile_point", "static_panel",
]
