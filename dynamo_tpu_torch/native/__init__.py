"""The port's native (C++) helpers: the store, the data plane and the
KV-event publisher, built by :mod:`._build` at first use."""
