"""Model modules with NeMo state_dict key names."""
