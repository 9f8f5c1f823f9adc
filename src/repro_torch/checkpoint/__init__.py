from .artifact import iter_pvqz, load_pvqz, read_toc, write_pvqz

__all__ = ["iter_pvqz", "load_pvqz", "read_toc", "write_pvqz"]
