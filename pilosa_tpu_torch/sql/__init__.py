"""SQL3 engine: a SQL dialect over the PQL/kernel engine.

Reference: sql3/ — hand-written parser (sql3/parser/parser.go), planner
compiling to PlanOperator trees (sql3/planner/executionplanner.go:32) with
PQL-bridging operators (oppqltablescan.go, oppqlaggregate.go,
oppqlgroupby.go, oppqldistinctscan.go). Here the planner lowers WHERE
trees to PQL filter calls (run by the executor's kernels) and falls
back to a host row-stream filter only for expressions with no bitmap
form.

Port of ``pilosa_tpu/sql``: the lexer, parser, planner, plan operators,
the bitwise semi-join plane, the engine and ``sql/fanout.py`` (the
cluster subtree fanout).
"""

from pilosa_tpu_torch.sql.engine import SQLEngine, SQLResult

__all__ = ["SQLEngine", "SQLResult"]
