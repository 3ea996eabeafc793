"""The plain float32 reference the benchmark judges the program's served
tokens by (``model.py``).  Imports nothing of the program."""
from alora_bench.reference.model import Reference, Seq, find_last

__all__ = ["Reference", "Seq", "find_last"]
