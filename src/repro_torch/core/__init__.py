"""The paper's protocol: GeoLoRA / GeoDoRA side-cars (``lora``), Grams and
CKA (``cka``), LAP precisions (``uncertainty``), the server's average
(``aggregation``), who reports each round (``participation``), the
sequential and node-stacked federated rounds (``federation``) and the
round engine (``engine``)."""
