from .logging import dbg, set_dbg_lvl, get_dbg_lvl, timed

__all__ = ["dbg", "set_dbg_lvl", "get_dbg_lvl", "timed"]
