"""Paper core: topology, routing, segmented errors, aggregation, protocols."""
