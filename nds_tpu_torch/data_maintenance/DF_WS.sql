-- Copied from nds_tpu/data_maintenance/DF_WS.sql, unchanged.
-- DF_WS: delete web channel rows in the [DATE1, DATE2] sales-date window
-- (role of reference nds/data_maintenance/DF_WS.sql).
DELETE FROM web_returns WHERE wr_order_number IN
  (SELECT ws_order_number FROM web_sales WHERE ws_sold_date_sk IN
    (SELECT d_date_sk FROM date_dim
     WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE)));
DELETE FROM web_sales WHERE ws_sold_date_sk IN
  (SELECT d_date_sk FROM date_dim
   WHERE d_date BETWEEN CAST('DATE1' AS DATE) AND CAST('DATE2' AS DATE))
