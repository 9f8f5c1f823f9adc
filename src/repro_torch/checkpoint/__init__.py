from .artifact import iter_pvqz, load_pvqz, read_toc, write_pvqz
from .checkpointer import Checkpointer

__all__ = ["Checkpointer", "iter_pvqz", "load_pvqz", "read_toc", "write_pvqz"]
