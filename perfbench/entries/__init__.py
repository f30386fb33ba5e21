"""The runners a traffic file names by its `entry`."""
