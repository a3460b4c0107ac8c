"""Weight bridges into the port's NeMo-keyed state_dict."""
