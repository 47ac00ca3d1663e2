"""The benchmark's own tests: `python -m pytest odom_bench/tests -q` on the
CPU; on the card `python -m pytest odom_bench/tests -q -m cuda`."""
