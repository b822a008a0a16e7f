"""Model code of the port: shared blocks with the GeoLoRA / GeoDoRA
linear, GQA attention, the dense transformer."""
