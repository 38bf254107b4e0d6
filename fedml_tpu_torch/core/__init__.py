"""Core services the ported paths use (bucketing, telemetry, device time).

Unlike ``fedml_tpu/core/__init__.py``, this package imports nothing at
package level, so importing one module loads only that module."""
