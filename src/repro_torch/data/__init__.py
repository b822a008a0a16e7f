"""The synthetic unpaired multimodal task and its frozen tokenizers."""
