"""Device-independent attention substrate of the port."""

from .merge import NEG, finalize_partial, merge_partials, merge_partials_axis

__all__ = ["NEG", "finalize_partial", "merge_partials", "merge_partials_axis"]
