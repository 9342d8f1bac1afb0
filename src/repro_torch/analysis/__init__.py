"""``repro_torch.analysis`` — the runtime lock-order sanitizer
(:mod:`repro_torch.analysis.lockdep`) that every lock of the engine is
built through.  The static rule framework arrives with a later slice."""
