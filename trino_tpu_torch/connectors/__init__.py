"""Connector SPI and the TPC-H generator."""
