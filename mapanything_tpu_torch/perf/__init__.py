"""Measurement tools of the port: device timing (:mod:`.timing`) and the
flash-attention forward's Hopper tuning probes (:mod:`.flash_probes`)."""
