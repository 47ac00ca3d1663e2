"""The benchmark's frozen yardstick: renderer, ATE, roofline arithmetic,
op counter, trace reduction and the manifest loader."""
