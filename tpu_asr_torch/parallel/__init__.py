"""Data parallelism across processes: process groups and the launcher."""
