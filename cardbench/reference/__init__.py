"""The benchmark's plain reference of a frame (imports nothing of the
system under test)."""
