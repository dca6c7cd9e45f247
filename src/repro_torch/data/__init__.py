"""Data generation for the port: TPC-H and TPC-DS tables (as frames or
as chunked store tables), and the synthetic LM corpus with its curation
and token batches."""
