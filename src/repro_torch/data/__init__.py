"""TPC-H data generation for the port."""
