"""The 22 TPC-H queries in the port's dataframe API."""
