"""Evaluation harnesses of the port: per-field next-token accuracy, the
composer classifier's success rates, and forward timing."""
