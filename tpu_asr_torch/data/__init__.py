"""Host-side data helpers of the port: audio loading and tokenizers."""
