"""The partition plan and its execution on DeviceMesh and DTensor: port of
``repro.sharding`` (``partition``, ``act_sharding``), and ``local``, where
a DTensor meets a kernel (the port's own)."""
