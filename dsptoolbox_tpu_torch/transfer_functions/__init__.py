"""Transfer-function measurement backend (`transfer_functions._backend`)."""
