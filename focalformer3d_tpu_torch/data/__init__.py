"""Synthetic LiDAR scenes for tests, benchmarks and the smoke run."""
