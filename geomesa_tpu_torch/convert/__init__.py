"""The converter layer's expression DSL (≙ ``geomesa_tpu.convert``): only
``expression``, which the ``transform`` query hint evaluates
(``index/shaping.py``). The converters and type inference are ROADMAP.md
Queue 1 item 15.
"""

from geomesa_tpu_torch.convert.expression import FUNCTIONS, parse_expression

__all__ = ["FUNCTIONS", "parse_expression"]
