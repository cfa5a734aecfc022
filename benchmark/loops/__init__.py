"""One closed loop per kind of traffic; a traffic file names its loop."""
