"""Multi-stream decode: N independent streams advanced in lock-step."""
