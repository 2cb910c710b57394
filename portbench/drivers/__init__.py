"""Traffic drivers. A traffic mix's file names its driver; a driver
builds the hub from the configuration, warms it, runs the timed window
and reads back what the window produced."""
