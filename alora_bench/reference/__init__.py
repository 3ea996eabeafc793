"""The plain float32 references the benchmark judges the program's served
tokens by: one file a model family (``<family>.py``), on what they share
(``common.py``).  Imports nothing of the program."""
from alora_bench.reference.common import Seq, find_last
from alora_bench.reference.stack import Reference

__all__ = ["Reference", "Seq", "find_last"]
