"""Runtime support: randomness, memory planning, timing, conversion."""
