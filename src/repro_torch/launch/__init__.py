"""Entry points: the federated LM training driver (``train``)."""
