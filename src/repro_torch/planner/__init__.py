"""Host-side plan encoding of the port: visit-table emission only (the
planners, the plan cache and the Eq.-5 encoder wait for the CP slice)."""

from .encode import emit_visit_tables, pick_buffer_bucket, visit_table_shapes

__all__ = ["emit_visit_tables", "pick_buffer_bucket", "visit_table_shapes"]
