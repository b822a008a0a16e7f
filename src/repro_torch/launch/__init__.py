"""Entry points: the federated LM training driver (``train``), the step
functions of the launch layer (``steps``: prefill, single-position
decode, the FedSGD round and the LM step) and the abstract inputs of
every architecture and input shape (``input_specs``)."""
