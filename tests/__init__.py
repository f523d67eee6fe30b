"""Test package (a regular package, so `tests.conftest` resolves here even
where another installed distribution ships a `tests` package)."""
