"""Data generation for the port: TPC-H tables, and the synthetic LM corpus
with its curation and token batches."""
