"""Dataframe subsystem: per-shard columnar data beside the bitmaps.

Port of ``pilosa_tpu/dataframe`` (reference: the experimental Arrow
dataframe, apply.go and arrow.go): per shard a table keyed by
shard-local position, queried through PQL ``Apply(filter?, "expr")`` and
``Arrow(filter?, header=[..])``. The expression language
(dataframe/expr.py) runs as eager ``torch`` ops over the shard-stacked
columns on the store's device.
"""

from pilosa_tpu_torch.dataframe.expr import ExprError, compile_expr
from pilosa_tpu_torch.dataframe.store import DataframeStore, ShardFrame

__all__ = ["DataframeStore", "ExprError", "ShardFrame", "compile_expr"]
