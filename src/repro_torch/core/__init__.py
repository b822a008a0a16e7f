"""The paper's protocol: GeoLoRA / GeoDoRA side-cars (``lora``), Grams and
CKA (``cka``), LAP precisions (``uncertainty``), the server's average
(``aggregation``) and the sequential federated round (``federation``)."""
